"""The port's attention kernels on the CPU: the plain versions of B14 and
B15 (``kernels.ref``) and the ``ops`` CPU route against the reference's
Pallas kernels (interpret mode) and against the functions the reference
model calls (``full_attention``, ``blocked_attention``,
``decode_attention_einsum``), on the same inputs made with numpy. The CUDA
kernels themselves run only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as JA
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import plan as P

# float32: the frameworks sum in other orders; bf16: the output rounds to
# bf16 (as tests/test_kernels.py holds the Pallas kernels)
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _bshd(t):
    """(B, H, S, D) torch → (B, S, H, D) jax float32."""
    return jnp.asarray(t.float().transpose(1, 2).numpy())


def _rep(jx, group):
    return jnp.repeat(jx, group, axis=2)


# (B, Hq, Hkv, Sq, Sk, D, window): tests/test_kernels.py's shapes, then
# G = 2, Sq < Sk (a prefix in the cache) with and without a window, then
# head_dim 192 (nemotron-4-340b's)
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, None),
    (2, 8, 2, 256, 256, 64, None),
    (1, 4, 1, 128, 128, 32, 48),
    (2, 6, 2, 192, 192, 64, None),
    (2, 4, 2, 64, 64, 32, 16),
    (1, 4, 2, 64, 192, 32, None),
    (2, 8, 2, 64, 256, 64, 100),
    (1, 4, 2, 64, 128, 192, None),
    (1, 2, 1, 128, 128, 192, 40),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,win", FLASH_CASES)
def test_flash_matches_pallas_and_model(B, Hq, Hkv, Sq, Sk, D, win, dtype):
    rng = np.random.default_rng(Sq + Sk + D)
    jq, q = _both(rng, (B, Hq, Sq, D), dtype)
    jk, k = _both(rng, (B, Hkv, Sk, D), dtype)
    jv, v = _both(rng, (B, Hkv, Sk, D), dtype)
    plain = ref.flash_attention_ref(q, k, v, causal=True, window=win)
    via_ops = ops.flash_attention(q, k, v, causal=True, window=win)
    assert torch.equal(plain, via_ops) and plain.dtype == q.dtype
    _close(plain, pallas_flash(jq, jk, jv, causal=True, window=win,
                               block_q=64, block_kv=64), dtype)
    _close(plain, jref.mha_ref(jq, jk, jv, causal=True, window=win), dtype)
    _close(ref.mha_ref(q, k, v, causal=True, window=win),
           jref.mha_ref(jq, jk, jv, causal=True, window=win), dtype)
    if dtype == "float32":
        # the functions the reference model calls, in its (B, S, H, D)
        # layout with the kv heads repeated (prepare_heads)
        G = Hq // Hkv
        args = (_bshd(q), _rep(_bshd(k), G), _rep(_bshd(v), G))
        kw = dict(causal=True, window=win, q_offset=Sk - Sq)
        got = plain.transpose(1, 2)
        _close(got, JA.full_attention(*args, **kw), dtype)
        _close(got, JA.blocked_attention(*args, **kw, block_q=32,
                                         block_kv=64), dtype)


# (B, Hq, Hkv, Sq, Sk, D, causal): an encoder's bidirectional self
# attention (Sq = Sk), cross-attention over a longer memory (Sq < Sk) and
# a shorter one (Sq > Sk), all keys live; then llava's odd group of 7
# (its 56 real q heads over 8 kv heads, here 14 over 2) causal and not,
# and qwen3-moe's group of 16
GROUP_CASES = [
    (2, 4, 4, 64, 64, 64, False),
    (2, 4, 4, 32, 128, 64, False),
    (1, 4, 4, 96, 64, 32, False),
    (2, 14, 2, 64, 64, 32, True),
    (1, 14, 2, 64, 128, 32, False),
    (1, 16, 1, 64, 64, 32, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", GROUP_CASES)
def test_flash_noncausal_and_odd_groups_match_pallas(B, Hq, Hkv, Sq, Sk, D,
                                                     causal, dtype):
    """B15's plain version without a causal mask (every key live, Sq and
    Sk apart) and at groups of 7 and 16: q head h reads kv head h // G, as
    the Pallas kernel in interpret mode, ``mha_ref`` and the reference
    model's ``full_attention`` (kv heads repeated, ``prepare_heads``)
    read it."""
    rng = np.random.default_rng(Sq + 3 * Sk + Hq)
    jq, q = _both(rng, (B, Hq, Sq, D), dtype)
    jk, k = _both(rng, (B, Hkv, Sk, D), dtype)
    jv, v = _both(rng, (B, Hkv, Sk, D), dtype)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    assert torch.equal(plain, ops.flash_attention(q, k, v, causal=causal))
    _close(plain, pallas_flash(jq, jk, jv, causal=causal, block_q=32,
                               block_kv=32), dtype)
    _close(plain, jref.mha_ref(jq, jk, jv, causal=causal), dtype)
    if dtype == "float32":
        G = Hq // Hkv
        got = JA.full_attention(_bshd(q), _rep(_bshd(k), G),
                                _rep(_bshd(v), G), causal=causal,
                                q_offset=Sk - Sq)
        _close(plain.transpose(1, 2), got, dtype)


@pytest.mark.parametrize("Hq,Hkv", [(14, 2), (16, 1)])
def test_decode_odd_groups_match_pallas(Hq, Hkv):
    """B14's plain version at groups of 7 (llava) and 16 (qwen3-moe), and
    over a fixed-length memory (every row at its full length, as the
    decoder's cross-attention reads the encoder's memory), against the
    Pallas kernel in interpret mode and the model's einsum."""
    B, S, D = 3, 96, 32
    rng = np.random.default_rng(Hq)
    jq, q = _both(rng, (B, Hq, D), "float32")
    jk, k = _both(rng, (B, Hkv, S, D), "float32")
    jv, v = _both(rng, (B, Hkv, S, D), "float32")
    for n in (_lengths(B, S, Hq), np.full(B, S, np.int32)):
        plain = ops.decode_attention(q, k, v, torch.from_numpy(n))
        jn = jnp.asarray(n)
        _close(plain, pallas_decode(jq, jk, jv, jn, block_kv=32), "float32")
        got = JA.decode_attention_einsum(
            jnp.asarray(q.numpy())[:, None], _rep(_bshd(k), Hq // Hkv),
            _rep(_bshd(v), Hq // Hkv), jn)
        _close(plain, np.asarray(got)[:, 0], "float32")


def test_flash_rows_without_keys_give_zero():
    """Sq > Sk: causal q rows before the first key have no live key. The
    Pallas kernel and the port's kernel function give 0 there;
    ``mha_ref`` gives the mean of V (a uniform softmax over -1e30)."""
    rng = np.random.default_rng(3)
    jq, q = _both(rng, (1, 2, 96, 32), "float32")
    jk, k = _both(rng, (1, 2, 64, 32), "float32")
    jv, v = _both(rng, (1, 2, 64, 32), "float32")
    plain = ref.flash_attention_ref(q, k, v)
    _close(plain, pallas_flash(jq, jk, jv, block_q=32, block_kv=32),
           "float32")
    assert torch.all(plain[:, :, :32] == 0)
    mean_v = v.mean(2, keepdim=True).expand(-1, -1, 32, -1)
    torch.testing.assert_close(ref.mha_ref(q, k, v)[:, :, :32], mean_v)


def _lengths(B, S, seed):
    """Ragged valid lengths with 1 and S among them."""
    n = np.random.default_rng(seed).integers(1, S + 1, B)
    n[0] = 1
    if B > 1:
        n[-1] = S
    return n.astype(np.int32)


DECODE_CASES = [(2, 8, 2, 256, 64), (1, 4, 4, 512, 128), (3, 6, 2, 128, 64),
                (4, 4, 2, 96, 32), (3, 8, 1, 200, 64), (2, 4, 2, 96, 192),
                (3, 10, 2, 64, 192)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODE_CASES)
def test_decode_matches_pallas_and_model(B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(S + D)
    jq, q = _both(rng, (B, Hq, D), dtype)
    jk, k = _both(rng, (B, Hkv, S, D), dtype)
    jv, v = _both(rng, (B, Hkv, S, D), dtype)
    n = _lengths(B, S, S)
    lengths = torch.from_numpy(n)
    plain = ref.decode_attention_window_ref(q, k, v, lengths)
    assert torch.equal(plain, ops.decode_attention(q, k, v, lengths))
    jn = jnp.asarray(n)
    bk = next(b for b in (32, 16, 8) if S % b == 0)   # Pallas: divisors
    _close(plain, pallas_decode(jq, jk, jv, jn, block_kv=bk), dtype)
    _close(plain, jref.decode_attention_ref(jq, jk, jv, jn), dtype)
    _close(ref.decode_attention_ref(q, k, v, lengths),
           jref.decode_attention_ref(jq, jk, jv, jn), dtype)
    if dtype == "float32":
        G = Hq // Hkv
        got = JA.decode_attention_einsum(
            jnp.asarray(q.numpy())[:, None], _rep(_bshd(k), G),
            _rep(_bshd(v), G), jn)
        _close(plain, np.asarray(got)[:, 0], dtype)


@pytest.mark.parametrize("window", [1, 5, 64])
@pytest.mark.parametrize("scalar", [True, False])
def test_decode_window_matches_model(window, scalar):
    """The window the Pallas kernel lacks and the model's function has:
    ``kpos > length - 1 - window``, for a scalar and a (B,) length."""
    B, Hq, Hkv, S, D = 3, 4, 2, 80, 32
    rng = np.random.default_rng(window)
    _, q = _both(rng, (B, Hq, D), "float32")
    _, k = _both(rng, (B, Hkv, S, D), "float32")
    _, v = _both(rng, (B, Hkv, S, D), "float32")
    n = np.full(B, 57, np.int32) if scalar else _lengths(B, S, window)
    plain = ops.decode_attention(q, k, v, torch.from_numpy(n), window=window)
    length = jnp.int32(57) if scalar else jnp.asarray(n)
    got = JA.decode_attention_einsum(
        jnp.asarray(q.numpy())[:, None], _rep(_bshd(k), 2), _rep(_bshd(v), 2),
        length, window=window)
    _close(plain, np.asarray(got)[:, 0], "float32")


def test_decode_strided_cache_view_and_zero_length():
    """The model passes its (B, S_max, Hkv, D) cache as a (B, Hkv, S, D)
    view: the plain version reads it as the contiguous copy. A length-0
    row gives 0 (the Pallas kernel's l clamp); ``decode_attention_ref``
    gives the mean of V there."""
    rng = np.random.default_rng(7)
    cache_k = torch.from_numpy(rng.normal(size=(2, 48, 2, 32)).astype(
        np.float32))
    cache_v = torch.from_numpy(rng.normal(size=(2, 48, 2, 32)).astype(
        np.float32))
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 32)).astype(np.float32))
    lengths = torch.tensor([0, 30], dtype=torch.int32)
    kv, vv = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    assert not kv.is_contiguous()
    got = ops.decode_attention(q[:, 0], kv, vv, lengths)
    want = ops.decode_attention(q[:, 0].contiguous(), kv.contiguous(),
                                vv.contiguous(), lengths)
    assert torch.equal(got, want)
    assert torch.all(got[0] == 0)
    _close(got, pallas_decode(jnp.asarray(q[:, 0].numpy()),
                              jnp.asarray(kv.contiguous().numpy()),
                              jnp.asarray(vv.contiguous().numpy()),
                              jnp.asarray(lengths.numpy()), block_kv=16),
           "float32")
    mean_v = vv[0].mean(1).repeat_interleave(2, dim=0)
    torch.testing.assert_close(ref.decode_attention_ref(
        q[:, 0], kv, vv, lengths)[0], mean_v)


def test_cpu_tensors_never_reach_the_attention_kernels():
    """On CPU tensors the plain versions run and no launch is counted; the
    kernel wrappers and backend "cuda" refuse them before any build, and a
    window below 1 is refused on both routes."""
    q, k = torch.zeros(1, 2, 8, 32), torch.zeros(1, 1, 8, 32)
    lengths = torch.ones(1, dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, :, 0], k, k, lengths)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(q[:, :, 0], k, k, lengths)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, backend="cuda")
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :, 0], k, k, lengths, backend="cuda")
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            ops.flash_attention(q, k, k, window=bad)
        with pytest.raises(ValueError, match="window"):
            ops.decode_attention(q[:, :, 0], k, k, lengths, window=bad)
    assert ops.LAUNCHES == before


# ------------------------------------------- the tensor-core body's numbers

def _split_terms(p, n):
    """p as n bf16 terms the way csrc/attention.cu's split3 takes them
    (each the top 8 significant bits of what is left), or rounded to
    nearest (``n`` negative: -n rounded terms)."""
    terms, rest = [], p
    for _ in range(abs(n)):
        if n > 0:
            t = (rest.view(torch.int32) & -65536).view(torch.float32)
        else:
            t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def _tc_emulation(q, k, v, *, causal=True, window=None, terms=3):
    """The bf16 tensor-core B15's arithmetic in plain PyTorch: S = Q K^T
    from bf16 operands with float32 sums, the scale on the float32
    accumulator, an online softmax over 64-key tiles (32 at D = 256) with
    exp as exp2 of the float32 product by log2(e) (the kernel's
    ``__expf``), masked scores weighing exactly 0, and P V as one bf16
    product per term of p's split, summed into float32 O."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G, bk = Hq // Hkv, (32 if D > 192 else 64)
    kf = k.float().repeat_interleave(G, 1).double()
    vf = v.float().repeat_interleave(G, 1)
    s = (q.float().double() @ kf.transpose(-1, -2)).float()
    s = s * torch.tensor(D ** -0.5, dtype=torch.float32)
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk)[None, :]
    live = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    s = torch.where(live, s, torch.tensor(ref.NEG))
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    exp = lambda x: torch.exp2((x * log2e).double()).float()
    m = torch.full((B, Hq, Sq, 1), ref.NEG)
    l = torch.zeros(B, Hq, Sq, 1)
    o = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk, bk):
        st = s[..., k0:k0 + bk]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.where(st > ref.NEG / 2, exp(st - mn), torch.tensor(0.0))
        alpha = exp(m - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = sum(t.double() @ vf[..., k0:k0 + bk, :].double()
                 for t in _split_terms(p, terms))
        o = o * alpha + pv.float()
        m = mn
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def test_split_into_three_terms_is_exact():
    """Three truncated bf16 terms hold every float32 p in [0, 1] exactly
    (above 2^-110, where the third term would leave the normal range; a p
    that small adds nothing next to the row's maximum 1); two rounded
    terms leave up to 2^-16 of p."""
    g = torch.Generator().manual_seed(0)
    p = torch.cat([torch.rand(100000, generator=g),
                   torch.rand(1000, generator=g) * 2.0 ** -100,
                   torch.tensor([0.0, 1.0, 0.5, 2.0 ** -110])])
    t = _split_terms(p, 3)
    assert all(torch.equal(x.to(torch.bfloat16).float(), x) for x in t)
    assert torch.equal((t[0] + t[1]) + t[2], p)
    t2 = _split_terms(p, -2)
    rel = ((t2[0] + t2[1]) - p).abs() / p.clamp_min(1e-38)
    assert 0 < float(rel.max()) <= 2.0 ** -16


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,win", [
    (2, 4, 2, 192, 192, 128, None),
    (1, 8, 1, 96, 160, 64, 48),
    (1, 4, 2, 130, 130, 192, None),
    (1, 2, 1, 70, 70, 256, None),
    (2, 4, 4, 100, 100, 32, None),
])
def test_tensor_core_arithmetic_meets_the_bf16_gate(B, Hq, Hkv, Sq, Sk, D,
                                                     win):
    """The kernel's arithmetic, emulated, within chip_smoke.py's bf16 gate
    (one bf16 ulp, 2^-7 relative, plus 1e-6) of the plain version on bf16
    inputs, at every shape; the emulation rounds p's terms exactly as the
    kernel does."""
    g = torch.Generator().manual_seed(Sq + D)
    r = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16)
    q, k, v = r(B, Hq, Sq, D), r(B, Hkv, Sk, D), r(B, Hkv, Sk, D)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=win).float()
    got = _tc_emulation(q, k, v, causal=True, window=win).float()
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all())


# ----------------------------------------- the cluster decode kernel's numbers

F32 = np.float32


def _fma(a, b, c):
    """fmaf on float32 arrays: the exact product plus c, rounded once (the
    float64 sum can round first, a tie a float32 kernel never meets here)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _merge(ms, ls, accs):
    """Partials (m, l, acc) merged in the order given, as the kernel merges
    warps and then ranks: M the max, each weighed by exp(m - M)."""
    M = ms[0]
    for m in ms[1:]:
        M = np.maximum(M, m)
    L, A = np.zeros_like(ls[0]), np.zeros_like(accs[0])
    for m, l, a in zip(ms, ls, accs):
        c = np.exp(m - M)
        L = L + c * l
        A = A + c[..., None] * a
    return M, L, A


def _decode_emulation(q, k, v, lengths, *, window=None, splits=None):
    """csrc/attention.cu decode_cluster_kernel's arithmetic in numpy
    float32, for one (b, kv head) pair at a time with its G q heads: the
    slice bounds of ``plan.decode_plan``'s splits (or ``splits``); in each
    slice 16 key streams (stream s takes keys s0 + s, s0 + s + 16, ...),
    two keys a tile; a key's score as 16 lanes' fma chains over D / 16
    elements each, summed by the half-warp's xor butterfly; the online
    softmax per stream with masked scores weighing exactly 0; then each
    warp's two streams merged (the even one first), the 8 warps in order,
    and the slices in rank order; out = acc / max(l, 1e-30)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G, E = Hq // Hkv, D // 16
    ns = splits or P.decode_plan(B=B, Hkv=Hkv, G=G, S=S, D=D,
                                 elem_bytes=q.element_size()).splits
    qf = q.float().numpy() * F32(D ** -0.5)
    kf, vf = k.float().numpy(), v.float().numpy()
    neg = F32(ref.NEG)
    out = np.zeros((B, Hq, D), F32)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        lo = max(0, n - window) if window else 0
        chunk = -(-(n - lo) // ns)
        for kh in range(Hkv):
            qs = qf[b, kh * G:(kh + 1) * G].reshape(G, 16, E)
            ranks = []
            for r in range(ns):
                s0 = lo + r * chunk
                s1 = min(n, s0 + chunk)
                streams = []
                for st in range(16):
                    m = np.full(G, neg, F32)
                    l = np.zeros(G, F32)
                    acc = np.zeros((G, D), F32)
                    keys = list(range(s0 + st, s1, 16))
                    for t in range(0, len(keys), 2):
                        sc, vs = [], []
                        for key in keys[t:t + 2]:
                            kk = kf[b, kh, key].reshape(16, E)
                            d = np.zeros((G, 16), F32)
                            for e in range(E):
                                d = _fma(qs[..., e], kk[None, :, e], d)
                            for o in (8, 4, 2, 1):
                                d = d + d[:, np.arange(16) ^ o]
                            sc.append(d[:, 0])
                            vs.append(vf[b, kh, key])
                        mx = m
                        for x in sc:
                            mx = np.maximum(mx, x)
                        alpha = np.exp(m - mx)
                        p = [np.exp(x - mx) for x in sc]
                        ps = F32(0) + sum(p[1:], p[0])
                        l = _fma(l, alpha, ps)
                        acc = acc * alpha[:, None]
                        for pu, vu in zip(p, vs):
                            acc = _fma(pu[:, None], vu[None, :], acc)
                        m = mx
                    streams.append((m, l, acc))
                warps = [_merge(*zip(*streams[w:w + 2]))
                         for w in range(0, 16, 2)]
                ranks.append(_merge(*zip(*warps)))
            _, L, A = _merge(*zip(*ranks))
            out[b, kh * G:(kh + 1) * G] = A / np.maximum(L, F32(1e-30))[:,
                                                                        None]
    return torch.from_numpy(out).to(q.dtype)


# (B, Hq, Hkv, S, D, window, lengths, splits): lengths 0, 1 and S; MQA
# with a window; head_dim 192; the qwen3-0.6b grouping at a short cache;
# one slice (no cluster) and eight (the largest cluster)
DECODE_EMU = [(3, 4, 2, 96, 64, None, [0, 1, 96], None),
              (2, 8, 1, 200, 128, 50, [1, 200], None),
              (3, 4, 2, 144, 192, None, [144, 0, 77], None),
              (2, 16, 8, 256, 128, None, [256, 137], None),
              (2, 4, 2, 160, 64, 33, [160, 90], 1),
              (2, 4, 2, 320, 64, None, [320, 41], 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,win,lens,splits", DECODE_EMU)
def test_cluster_decode_arithmetic_meets_the_gates(B, Hq, Hkv, S, D, win,
                                                  lens, splits, dtype):
    """The cluster decode kernel's arithmetic, emulated, within
    chip_smoke.py's gates of the plain version
    (``decode_attention_window_ref``): 1e-5 in float32, one bf16 ulp
    (2^-7 relative, plus 1e-6) in bf16; a length-0 row gives 0; and in
    float32 within the test's tolerance of the Pallas kernel (interpret
    mode; it has no window, so windowed cases meet the model's
    ``decode_attention_einsum`` instead)."""
    rng = np.random.default_rng(S + D)
    jq, q = _both(rng, (B, Hq, D), dtype)
    jk, k = _both(rng, (B, Hkv, S, D), dtype)
    jv, v = _both(rng, (B, Hkv, S, D), dtype)
    n = np.asarray(lens, np.int32)
    lengths = torch.from_numpy(n)
    got = _decode_emulation(q, k, v, n, window=win, splits=splits)
    want = ref.decode_attention_window_ref(q, k, v, lengths, window=win)
    assert got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert float(d.max()) <= 1e-5
        if win is None:
            bk = next(b for b in (32, 16, 8) if S % b == 0)
            _close(got, pallas_decode(jq, jk, jv, jnp.asarray(n),
                                      block_kv=bk), dtype)
        else:
            G = Hq // Hkv
            ein = JA.decode_attention_einsum(
                jnp.asarray(q.numpy())[:, None], _rep(_bshd(k), G),
                _rep(_bshd(v), G), jnp.asarray(n), window=win)
            rows = n > 0   # the model's function gives the mean of V at 0
            _close(got[rows], np.asarray(ein)[:, 0][rows], dtype)
    else:
        assert bool((d <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    assert bool((got[torch.from_numpy(n == 0)] == 0).all())


def test_cluster_decode_slices_cover_the_live_keys_once():
    """The slice and stream bounds the kernel computes cover [lo, len)
    exactly once for every split count and length, with a window and
    without; each warp's even stream has the most keys (both of its
    streams run its tiles)."""
    for S in (1, 15, 96, 1000):
        for ns in (1, 2, 3, 4, 8):
            for n in {0, 1, S // 2, S}:
                for win in (None, 7):
                    lo = max(0, n - win) if win else 0
                    chunk = -(-(n - lo) // ns)
                    seen = []
                    for r in range(ns):
                        s0 = lo + r * chunk
                        s1 = min(n, s0 + chunk)
                        nk = [len(range(s0 + st, s1, 16)) for st in range(16)]
                        assert all(nk[2 * w] >= nk[2 * w + 1]
                                   for w in range(8))
                        for st in range(16):
                            seen += range(s0 + st, s1, 16)
                    assert sorted(seen) == list(range(lo, n))


if __name__ == "__main__":
    # The emulation at the qwen3-0.6b serve shape (B=8, 16 q / 8 kv heads
    # of 128, causal S=512, bf16 inputs from seed 0): outputs past the
    # bf16 gate with p in three exact terms (the kernel's) and in two
    # rounded ones. PYTHONPATH=src python tests/test_torch_attention.py
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16)
    q, k, v = r(8, 16, 512, 128), r(8, 8, 512, 128), r(8, 8, 512, 128)
    want = ref.flash_attention_ref(q, k, v).float()
    tol = 2.0 ** -7 * want.abs() + 1e-6
    for terms in (3, -2):
        d = (_tc_emulation(q, k, v, terms=terms).float() - want).abs()
        print(f"p in {abs(terms)} {'exact' if terms > 0 else 'rounded'} "
              f"terms: {int((d > tol).sum())} of {d.numel()} outputs past "
              f"the gate, worst |err| / tol {float((d / tol).max()):.3f}")
