"""Tensor parallelism over a mesh's ``model`` axis: Megatron's local forms,
their collectives under autograd.

A param is a DTensor laid out by ``training.param_shardings`` (the rule
table): a form reads the placement of its weight on ``model``
(``split_dim``) and computes on the rank's piece (``local``). A weight the
table leaves whole (a dim ``model`` does not divide, a plain tensor, a mesh
of one ``model`` rank) takes the one-device math, so one set of forms
serves every layout. Activations between the forms are replicated over
``model``: every rank of a ``model`` group holds the same residual stream.

The collectives, each an autograd Function whose backward is its
transpose:

* ``copy`` (Megatron's f): the identity, the gradient all-reduced: in
  front of a product on the rank's piece of a weight, whose input gradient
  is the rank's part of the whole one;
* ``reduce`` (Megatron's g): the all-reduce of partial products, the
  gradient passed through;
* ``gather``: the all-gather of the rank's columns, the rank's slice of
  the gradient (every rank computes alike from the gathered value);
* ``gather(summed=True)``: the all-gather, the gradient all-reduced before
  the rank's slice is kept (each rank reads its own part of the gathered
  value: the router's columns its experts' gates couple, the kv heads its
  q heads read);
* ``reduce_slices``: the all-reduce of partial products of which each
  rank keeps its own columns, the gradient all-gathered (the RG-LRU
  gates);
* ``share``: the identity, the gradient divided by the ``model`` size (a
  term every rank computes alike whose gradient the sums over ``model``
  would otherwise count once a rank: the MoE's load-balancing term).

The forms: ``row`` (a product on the rank's input rows, reduced),
``embed`` (the vocab-parallel lookup: ids outside the rank's slice read
0, the rows reduced), ``logits`` (the head's columns, gathered: serving
needs the whole row), ``cross_entropy`` (the vocab-parallel loss on the
rank's columns, Megatron's: no whole row of logits is built), ``mlp``
(the column- then row-parallel pair, the hidden dim split between them),
``qkv`` (the projections on the rank's heads, qk-norm and RoPE),
``kv_for_q`` (the kv heads the rank's q heads read), ``real_heads`` (a
VLM's padded heads in training), ``moe`` (expert
parallelism: every rank routes alike, runs its own experts and the partial
outputs are reduced), ``lstm_scan`` (an LSTM layer on the rank's gate
rows, the gate preactivations gathered each step) and the recurrent mixers
on the rule table's split (``rglru``: the rank's ``d_rnn`` columns;
``rwkv_time_mix``: its heads; ``rwkv_channel_mix``: Megatron's pair). The
training forward and backward, the prefill and the split-KV decode step
of every ``TransformerLM`` family and of ``EncDecLM``, and the LSTM's
training forward run through them; each form's gradient is the one-device
gradient's piece on the rank. A replicated weight that scales the rank's
part of an activation (qk-norm, RWKV6's token-shift lerps) is passed
through ``copy`` so its gradient sums over ``model``.

Every rank builds the same graph in the same order (its values and
indices differ, never its collectives), so the backward issues its
collectives in the same order on every rank.

Every collective goes through ``collective_ops`` (staged through host
memory where gloo carries card tensors); the partial sums reduce in
float32 and cast back.
"""
from __future__ import annotations

import torch

from ..sharding import mesh_axes
from .collective_ops import all_reduce_axis, gather_axis

__all__ = ["TensorParallel", "local", "kv_heads"]


def local(w):
    """The rank's piece of a DTensor (differentiable), or ``w`` itself."""
    from torch.distributed.tensor import DTensor
    return w.to_local() if isinstance(w, DTensor) else w


def _reduce_model(t: torch.Tensor, mesh) -> torch.Tensor:
    return all_reduce_axis(t.float(), mesh, "model").to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_model(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce_model(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, rank, summed):
        ctx.mesh, ctx.summed = mesh, summed
        ctx.dim, ctx.rank, ctx.size = dim, rank, x.shape[dim]
        return gather_axis(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _reduce_model(g, ctx.mesh)
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None,
                None, None)


class _ReduceSlices(torch.autograd.Function):
    """x (..., pieces · W) partial sums → the rank's W / n columns of each
    of the ``pieces`` blocks of the all-reduced sum, side by side; the
    gradient: every rank's columns all-gathered back into x's layout."""

    @staticmethod
    def forward(ctx, x, mesh, pieces, rank, n):
        ctx.mesh, ctx.pieces, ctx.n = mesh, pieces, n
        per = x.shape[-1] // pieces // n
        return torch.cat([b.narrow(-1, rank * per, per) for b in torch.split(
            _reduce_model(x, mesh), x.shape[-1] // pieces, dim=-1)], -1)

    @staticmethod
    def backward(ctx, g):
        whole = gather_axis(g.contiguous(), ctx.mesh, "model", g.ndim - 1)
        per = g.shape[-1] // ctx.pieces
        whole = whole.reshape(*g.shape[:-1], ctx.n, ctx.pieces, per)
        return (whole.transpose(-3, -2).reshape(*g.shape[:-1], -1), None,
                None, None, None)


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _VocabCE(torch.autograd.Function):
    """Each position's cross-entropy over a vocab-split head (Megatron's
    vocab-parallel loss): z (N, V / n) float32, the rank's columns of the
    logits, its pad columns already at -1e30; ``loc`` (N,) the labels'
    columns on this rank and ``live`` where a label lies there. The row
    max all-reduced (max), then the sums of exp(z - max) and the label's
    logit (sum, one message). Returns nll (N,) float32, alike on every
    rank; its backward, ``softmax - onehot`` on the rank's columns, runs
    no collective."""

    @staticmethod
    def forward(ctx, z, loc, live, mesh):
        m = all_reduce_axis(z.amax(dim=-1), mesh, "model", op="max")
        e = (z - m[:, None]).exp_()
        ll = torch.gather(z, -1, loc[:, None])[:, 0]
        both = all_reduce_axis(torch.stack(
            [e.sum(dim=-1), torch.where(live, ll, torch.zeros_like(ll))]),
            mesh, "model")
        e.div_(both[0][:, None])
        ctx.save_for_backward(e, loc, live)
        return m + torch.log(both[0]) - both[1]

    @staticmethod
    def backward(ctx, g):
        e, loc, live = ctx.saved_tensors
        grad = e * g[:, None]
        grad.scatter_add_(-1, loc[:, None],
                          torch.where(live, -g, torch.zeros_like(g))[:, None])
        return grad, None, None, None


def kv_heads(k, v, idx: list):
    """k / v (B, S, Hkv, D) at kv heads ``idx``, one a q head (Python ints:
    the index map is layout, not data, and a trace on fake tensors reads no
    tensor's values): a slice where ``idx`` is a plain GQA grouping of a
    block of kv heads, else an ``index_select`` (each q head its own kv
    head)."""
    kv0, kv1 = idx[0], idx[-1] + 1
    n, hq = kv1 - kv0, len(idx)
    if hq % n == 0 and idx == [kv0 + i // (hq // n) for i in range(hq)]:
        return k[:, :, kv0:kv1], v[:, :, kv0:kv1]
    t = torch.tensor(idx, device=k.device)
    return k.index_select(2, t), v.index_select(2, t)


class TensorParallel:
    """The local forms over ``mesh``'s ``model`` axis (None, or a mesh
    without one: every form is the one-device math)."""

    def __init__(self, mesh=None):
        sizes = mesh_axes(mesh) if mesh is not None else {}
        self.mesh = mesh
        self.n = sizes.get("model", 1)
        self._axis = list(sizes).index("model") if self.n > 1 else None
        self.rank = (mesh.get_local_rank("model") if self.n > 1 else 0)

    # ------------------------------------------------------------ layout
    def split_dim(self, w) -> int | None:
        """The dim of ``w`` split over ``model``, or None (whole)."""
        from torch.distributed.tensor import DTensor
        if self._axis is None or not isinstance(w, DTensor):
            return None
        pl = w.placements[self._axis]
        return pl.dim if pl.is_shard() else None

    def whole(self, w):
        """``w``'s whole tensor: its pieces gathered over ``model`` where
        split there."""
        d = self.split_dim(w)
        return local(w) if d is None else self.gather(local(w), d)

    def rank_slice(self, x, dim: int, whole: int):
        """The rank's block of ``x``'s dim ``dim`` (of ``whole`` entries,
        split evenly over ``model``)."""
        per = whole // self.n
        return x.narrow(dim, self.rank * per, per)

    # ------------------------------------------------------- collectives
    def copy(self, x):
        return x if self._axis is None else _Copy.apply(x, self.mesh)

    def reduce(self, x):
        return x if self._axis is None else _Reduce.apply(x, self.mesh)

    def gather(self, x, dim: int, summed: bool = False):
        if self._axis is None:
            return x
        return _Gather.apply(x, self.mesh, dim % x.ndim, self.rank, summed)

    def reduce_slices(self, x, pieces: int):
        """The rank's columns of each of x's ``pieces`` blocks of partial
        sums, all-reduced; the gradient all-gathered."""
        if self._axis is None:
            return x
        return _ReduceSlices.apply(x, self.mesh, pieces, self.rank, self.n)

    def share(self, x):
        if self._axis is None:
            return x
        return _Share.apply(x, self.n)

    # ------------------------------------------------------------- forms
    def row(self, h, w, flat_in: int = 1):
        """h @ w over h's last ``flat_in`` dims flattened; with w's input
        rows split, h is the rank's piece of them and the partial products
        are reduced."""
        from ..models.layers import pmm
        wl = local(w)
        y = pmm(h.reshape(*h.shape[:h.ndim - flat_in], -1),
                wl.reshape(-1, wl.shape[-1]))
        return self.reduce(y) if self.split_dim(w) == 0 else y

    def norm(self, kind: str, p: dict, x):
        from ..models.layers import apply_norm
        return apply_norm(kind, {k: local(v) for k, v in p.items()}, x)

    def embed(self, table, tokens):
        """The rows of ``tokens``: on a vocab-split table each rank looks
        up the ids of its slice, the others read 0, and the rows are
        reduced (one rank holds each id: the sum is exact)."""
        tl = local(table)
        if self.split_dim(table) != 0:
            return tl[tokens]
        loc = tokens - self.rank * tl.shape[0]
        live = (loc >= 0) & (loc < tl.shape[0])
        rows = tl[loc.clamp(0, tl.shape[0] - 1)]
        return self.reduce(torch.where(live[..., None], rows,
                                       torch.zeros_like(rows)))

    def logits(self, p_head: dict, x, real_vocab: int):
        """``layers.logits_apply``: x @ head float32, the pad columns at
        -1e30; a vocab-split head's columns gathered over ``model``."""
        from ..models.layers import logits_apply
        w = p_head["w"]
        if self.split_dim(w) != 1:
            return logits_apply({"w": local(w)}, x, real_vocab)
        y = self.gather(torch.matmul(self.copy(x), local(w)).float(), -1)
        if w.shape[-1] != real_vocab:
            pad = torch.arange(w.shape[-1], device=x.device) >= real_vocab
            y = y.masked_fill(pad, -1e30)
        return y

    def cross_entropy(self, p_head: dict, x, labels, mask, real_vocab: int):
        """The next-token loss ``core.metrics.cross_entropy(logits[:, :-1],
        labels[:, 1:], mask)`` of the logits ``logits`` gives on x (B, S,
        d). With the head split over ``model`` on its vocabulary, the
        vocab-parallel form (``_VocabCE``) on the rank's columns of x[:,
        :-1] @ head in float32, the pad columns (>= ``real_vocab``, on the
        last ranks) at -1e30: no (rows, whole vocabulary) tensor is made.
        The same masked mean (an all-zero mask gives 0)."""
        from ..core.metrics import cross_entropy
        w = p_head["w"]
        if self.split_dim(w) != 1:
            return cross_entropy(self.logits(p_head, x, real_vocab)[:, :-1],
                                 labels[:, 1:], mask)
        wl = local(w)
        v = wl.shape[-1]
        h = self.copy(x[:, :-1])
        z = torch.matmul(h, wl).float().reshape(-1, v)
        v0 = self.rank * v
        if v0 + v > real_vocab:
            pad = torch.arange(v0, v0 + v, device=x.device) >= real_vocab
            z = z.masked_fill(pad, -1e30)
        loc = labels[:, 1:].reshape(-1).long() - v0
        live = (loc >= 0) & (loc < v)
        nll = _VocabCE.apply(z, loc.clamp(0, v - 1), live, self.mesh)
        if mask is not None:
            mask = mask.float().reshape(-1)
            return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
        return nll.mean()

    def mlp(self, p: dict, x, activation: str):
        """``layers.mlp_apply``; with the hidden dim split, Megatron's
        pair: the up (and gate) products on the rank's hidden columns, the
        down product on its rows, reduced."""
        from ..models.layers import _act, mlp_apply, pmm
        if self.split_dim(p["w_down"]) != 0:
            return mlp_apply({k: local(v) for k, v in p.items()}, x,
                             activation)
        xc = self.copy(x)
        if activation.endswith("_glu"):
            h = _act(activation, pmm(xc, local(p["w_gate"]))) * pmm(
                xc, local(p["w_up"]))
        else:
            h = _act(activation, pmm(xc, local(p["w_up"])))
        return self.reduce(pmm(h, local(p["w_down"])))

    def qkv(self, p: dict, x, rot, *, qk_norm: bool):
        """``attention.qkv_project`` on the rank's q heads (all of them
        when ``wq`` is whole); k and v on the rank's kv heads when ``wk`` /
        ``wv`` are split, else whole (each rank computes them alike, and
        ``copy`` sums the gradients of the heads the ranks read). The
        replicated qk-norm weights scale the rank's heads: their gradients
        are summed too."""
        from ..models.attention import qkv_project
        from ..models.layers import apply_rope, pmm, rmsnorm
        if self.split_dim(p["wq"]) is None:
            return qkv_project({k: local(v) for k, v in p.items()}, x, rot,
                               qk_norm=qk_norm)
        kv_split = self.split_dim(p["wk"]) == 1
        xc = self.copy(x)
        xk = xc if kv_split else x
        q = pmm(xc, local(p["wq"]))
        k, v = pmm(xk, local(p["wk"])), pmm(xk, local(p["wv"]))
        if qk_norm:
            q = rmsnorm(q, self.copy(local(p["q_norm"])))
            kn = local(p["k_norm"])
            k = rmsnorm(k, self.copy(kn) if kv_split else kn)
        if rot is not None:
            q, k = apply_rope(q, *rot), apply_rope(k, *rot)
        if not kv_split:
            k, v = self.copy(k), self.copy(v)
        return q, k, v

    def kv_for_q(self, q, k, v, num_heads: int, num_kv_heads: int):
        """The kv heads the rank's q heads (``q``'s, of ``num_heads``)
        read: k / v as they are when q is whole or their heads split with
        q's; else (k / v whole) the rank's block of kv heads, or each q
        head's own kv head where the block is not a plain GQA group."""
        hq = q.shape[2]
        if hq == num_heads or k.shape[2] < num_kv_heads:
            return k, v
        G = num_heads // num_kv_heads        # q heads a kv head
        return kv_heads(k, v, [h // G for h in range(self.rank * hq,
                                                     (self.rank + 1) * hq)])

    def real_heads(self, q, k, v, num_heads: int, num_kv_heads: int):
        """Training attention on the rank's block of stored q heads where
        ``pad_heads_to`` pads them (a block can hold real and dummy heads
        together): (q, k, v, real) with k / v one kv head a q head, the kv
        head the one-device map gives its global index g (g // (num_heads
        / num_kv_heads); a dummy head reads the last), and ``real`` (hq, 1)
        1 on the real heads, by which the caller scales the outputs, as
        the reference masks its dummy heads. Split kv heads are gathered
        over ``model`` (their gradient summed: a rank's q heads read other
        ranks' kv heads). Every rank attends all its heads, so every rank
        runs the same graph."""
        hq = q.shape[2]
        if k.shape[2] < num_kv_heads:
            k, v = self.gather(k, 2, summed=True), self.gather(v, 2,
                                                              summed=True)
        g0 = self.rank * hq
        G = num_heads // num_kv_heads
        k, v = kv_heads(k, v, [min((g0 + i) // G, num_kv_heads - 1)
                               for i in range(hq)])
        real = (torch.arange(g0, g0 + hq, device=q.device)
                < num_heads).to(q.dtype)[:, None]
        return q, k, v, real

    def moe(self, p: dict, x, **kw):
        """``moe.moe_apply`` (``kw``: its keywords); with the experts split
        over ``model``, expert parallelism: the router's float32 columns
        gathered, so every rank routes alike (the one-device ids, ranks and
        drop set), each rank's FFN run for its own experts on the pairs
        routed to them, and the ranks' float32 partial outputs summed over
        ``model`` before the cast. In the backward a rank's combine
        weights reach every router column (the softmax couples them): the
        router's gradient is summed over ``model`` before each rank keeps
        its columns (``gather(summed=True)``), as x's is (``copy``); the
        load-balancing term, which every rank computes alike from the whole
        router, has its gradient divided by the ``model`` size
        (``share``), so those sums count it once. With the experts whole
        (a count ``model`` does not divide), the one-device function on
        whole weights. Returns (out in x's dtype, aux)."""
        from ..models.moe import moe_apply
        if self.split_dim(p["w_up"]) != 0:
            # experts whole: a leaf the rule table split on another dim
            # (an expert count ``model`` does not divide) is gathered
            return moe_apply({k: self.whole(v) for k, v in p.items()}, x,
                             **kw)
        mine = {k: local(v) for k, v in p.items()}
        if self.split_dim(p["router"]) == 1:
            mine["router"] = self.gather(mine["router"], 1, summed=True)
        n = mine["w_up"].shape[0]
        part, aux = moe_apply(mine, self.copy(x), **kw,
                              expert_range=(self.rank * n,
                                            (self.rank + 1) * n))
        return self.reduce(part).to(x.dtype), self.share(aux)

    def lstm_scan(self, lp: dict, xs, c0, h0, cell):
        """An LSTM layer over xs (B, T, X): with the gate rows split, each
        step's preactivations z on the rank's rows, gathered (B, 4H) over
        ``model``; ``cell(z, c) → (c, h)`` on every rank alike. Returns
        (hs (B, T, H), (c_T, h_T))."""
        split = self.split_dim(lp["w_x"]) == 0
        wx, wh, b = (local(lp[k]) for k in ("w_x", "w_h", "b"))
        if split:
            xs = self.copy(xs)
        c, h = c0, h0
        hs = []
        for t in range(xs.shape[1]):
            hin = self.copy(h) if split else h
            z = (xs[:, t] @ wx.T + hin @ wh.T + b[None, :]).float()
            if split:
                z = self.gather(z, -1)
            c, h = cell(z, c)
            hs.append(h)
        return torch.stack(hs, 1), (c, h)

    def rglru(self, p: dict, x, state=None, *, step: bool = False):
        """``recurrent.rglru_apply`` (``step``: ``rglru_step`` from
        ``state``); with ``d_rnn`` split over ``model`` (the rule table's
        ``mlp``), the rank's columns: ``w_in_gelu``, ``w_in_rec``, the
        conv and ``lam`` on them, the recurrence and its state (``h``,
        ``conv``) local; the two gates' partial products over the rank's
        rows of ``w_gate_a`` / ``w_gate_x`` all-reduced in one float32
        message, each rank keeping its own columns of both
        (``reduce_slices``: every rank's column gradients gathered back in
        the backward, since each rank's rows feed every rank's columns);
        ``w_out`` row-parallel, reduced."""
        from ..models import recurrent as R
        from ..models.layers import pmm
        mine = {k: local(v) for k, v in p.items()}
        fn = R.rglru_step if step else R.rglru_apply
        if self.split_dim(p["w_in_rec"]) != 1:
            return fn(mine, x, state)

        def gate_pre(pl, xr):
            both = self.reduce_slices(torch.cat([pmm(xr, pl["w_gate_a"]),
                                                 pmm(xr, pl["w_gate_x"])],
                                                -1), pieces=2)
            return torch.chunk(both, 2, dim=-1)
        return fn(mine, self.copy(x), state, gate_pre=gate_pre,
                  reduce=self.reduce)

    def rwkv_time_mix(self, p: dict, x, state, *, chunk: int,
                      step: bool = False):
        """``recurrent.rwkv_time_mix`` (``step``: ``rwkv_time_mix_step``);
        with the heads split over ``model``, the rank's heads (``w_r``,
        ``w_k``, ``w_v``, ``w_g``, ``w_w``, ``w0``, ``u``, ``gn``; ``S``
        local), ``w_out`` row-parallel, reduced; the replicated token-shift
        lerps ``mu`` through ``copy``."""
        from ..models import recurrent as R
        mine = {k: local(v) for k, v in p.items()}
        kw = {} if self.split_dim(p["w_r"]) != 1 else {"reduce": self.reduce}
        if kw:
            x = self.copy(x)
            mine["mu"] = self.copy(mine["mu"])
        if step:
            return R.rwkv_time_mix_step(mine, x, state, **kw)
        return R.rwkv_time_mix(mine, x, state, chunk=chunk, **kw)

    def rwkv_channel_mix(self, p: dict, x, state_x):
        """``recurrent.rwkv_channel_mix``; with its hidden dim split,
        Megatron's pair: ``w_cm1`` on the rank's columns, ``w_cm2`` on its
        rows, reduced; the replicated lerp ``mu_cm`` through ``copy``."""
        from ..models import recurrent as R
        mine = {k: local(v) for k, v in p.items()}
        if self.split_dim(p["w_cm2"]) != 0:
            return R.rwkv_channel_mix(mine, x, state_x)
        mine["mu_cm"] = self.copy(mine["mu_cm"])
        return R.rwkv_channel_mix(mine, self.copy(x), state_x,
                                  reduce=self.reduce)
