"""SparsityPolicy → SparsityPlan: one declaration drives prune and pack.

A policy is a list of rules, each mapping a param-path regex to a
(format, ratio) pair:

    policy = SparsityPolicy.of({"w_x$": ("row_balanced", 0.875),
                                "w_h$": ("row_balanced", 0.75)},
                               layout="out_in")
    plan = policy.compile(params)
    pruned, masks = plan.prune(params)         # masks: {path: bool mask}
    packed, report = plan.pack(pruned, masks)  # packed-format param tree
    y = plan.matvec("layers/0/w_x", packed["layers"][0]["w_x"], x)

Param trees are nested dicts / lists of tensors; a leaf's path joins its
keys and indices with "/" (``layers/0/w_x``). Weight layout per rule (how
a leaf maps to the (rows=output, cols=fan-in) matrix):

  "out_in"        (out, in...)   — the LSTM's W ∈ R^{4H×X} convention
  "in_out"        (in..., out)   — transformer projections (out = last dim)
  "out_trailing"  (in, out...)   — rwkv mixer weights
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Mapping

import torch

from .formats import SparseFormat, get_format

__all__ = ["Rule", "SparsityPolicy", "SparsityPlan", "lstm_policy",
           "transformer_policy", "classify", "apply_masks", "mask_grads",
           "sparsity_report"]

_LAYOUTS = ("out_in", "in_out", "out_trailing")


# ----------------------------------------------------------------- paths

def _leaves_with_path(tree, prefix: str = ""):
    """Yield (path, leaf) over nested dicts (sorted keys) and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map_with_path(tree, fn, prefix: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


# ----------------------------------------------------------------- rules

@dataclasses.dataclass(frozen=True)
class Rule:
    """One policy entry: params whose path matches ``pattern`` (re.search)
    are pruned with ``format`` at ``ratio``."""

    pattern: str
    format: str = "row_balanced"
    ratio: float = 0.0
    layout: str = "in_out"
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.layout not in _LAYOUTS:
            raise ValueError(f"layout must be one of {_LAYOUTS}, "
                             f"got {self.layout!r}")
        if not (0.0 <= self.ratio < 1.0):
            raise ValueError(f"ratio must be in [0, 1), got {self.ratio}")


@dataclasses.dataclass(frozen=True)
class _Site:
    """One matched param leaf, normalized to the (rows=out, cols=in) view.
    ``L``: the leading layer axis of a stacked leaf (the reference's
    scanned ``blocks/`` leaves), None for a per-layer one (the port's own
    trees)."""

    path: str
    rule: Rule
    fmt: SparseFormat
    d_in: int
    d_out: int
    shape: tuple
    dtype: Any
    L: int | None = None

    def to_oi(self, leaf: torch.Tensor) -> torch.Tensor:
        """leaf → (d_out, d_in) with rows = output units; (L, d_out, d_in)
        for a stacked leaf."""
        lead = (self.L,) if self.L else ()
        if self.rule.layout == "out_in":
            return leaf.reshape(*lead, self.d_out, self.d_in)
        return leaf.reshape(*lead, self.d_in, self.d_out).transpose(-1, -2)

    def from_oi(self, arr: torch.Tensor) -> torch.Tensor:
        if self.rule.layout == "out_in":
            return arr.reshape(self.shape)
        return arr.transpose(-1, -2).reshape(self.shape)


def _resolve_dims(layout: str, shape: tuple) -> tuple[int, int]:
    """→ (d_in, d_out) of an un-stacked (core) shape."""
    if layout == "out_in":
        return math.prod(shape[1:]), shape[0]
    if layout == "out_trailing":
        return shape[0], math.prod(shape[1:])
    return math.prod(shape[:-1]), shape[-1]


def _is_stacked(ps: str, ndim: int) -> bool:
    """A scanned leaf of the reference's layout, its first dim the layer
    axis: the decoder's ``blocks/<pattern position>/...`` and the
    encoder-decoder's ``enc_blocks/...`` / ``dec_blocks/...``. The port's
    own trees hold one layer a leaf (``layers/<i>/...``,
    ``enc_blocks/<i>/...``)."""
    return ndim >= 3 and re.search(r"(?:^|/)blocks/|_blocks/(?!\d+/)",
                                   ps) is not None


# ---------------------------------------------------------------- policy

@dataclasses.dataclass(frozen=True)
class SparsityPolicy:
    """Ordered weight rules (first match wins) selecting a (format, ratio)
    per param-path regex. (The kernel backend is chosen per call, by
    ``sparse.backend``, not here.)

    Examples
    --------
    >>> p = SparsityPolicy.of({r"w_x$": ("row_balanced", 0.875),
    ...                        r"w_h$": ("row_balanced", 0.75)},
    ...                       layout="out_in")
    >>> p.match("layers/0/w_x").ratio
    0.875
    >>> p.match("layers/0/b") is None
    True
    """

    rules: tuple
    activation: Any = None
    quant: Any = None

    @classmethod
    def of(cls, mapping: Mapping[str, Any], *, layout: str = "in_out",
           activation: Any = None, quant: Any = None) -> "SparsityPolicy":
        """Build a policy from ``{pattern: ratio | (format, ratio) |
        (format, ratio, options)}``; bare floats mean ``row_balanced``.
        ``activation`` is a temporal-delta rule (``DeltaGateConfig``),
        ``quant`` a fixed-point rule (``repro_torch.quant.QuantConfig``)."""
        rules = []
        for pat, spec in mapping.items():
            if isinstance(spec, (int, float)):
                rules.append(Rule(pat, "row_balanced", float(spec), layout))
            else:
                fmt, ratio, *rest = spec
                opts = rest[0] if rest else {}
                rules.append(Rule(pat, fmt, float(ratio), layout,
                                  dict(opts)))
        return cls(rules=tuple(rules), activation=activation, quant=quant)

    def with_activation(self, activation) -> "SparsityPolicy":
        """Copy of this policy with a temporal-delta activation rule
        (a ``DeltaGateConfig``, or None to disable)."""
        return dataclasses.replace(self, activation=activation)

    def with_quant(self, quant) -> "SparsityPolicy":
        """Copy of this policy with a fixed-point inference rule
        (a ``QuantConfig``, or None to disable)."""
        return dataclasses.replace(self, quant=quant)

    def match(self, path_str: str) -> Rule | None:
        """First rule whose pattern ``re.search``-matches ``path_str``."""
        for r in self.rules:
            if re.search(r.pattern, path_str):
                return r
        return None

    def compile(self, params) -> "SparsityPlan":
        """Resolve every matched ≥2-D leaf to a (format, layout, dims)
        site; only shapes and dtypes are read."""
        sites = {}
        for ps, leaf in _leaves_with_path(params):
            if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
                continue
            rule = self.match(ps)
            if rule is None or rule.ratio <= 0.0:
                continue
            shape = tuple(leaf.shape)
            L = shape[0] if _is_stacked(ps, leaf.ndim) else None
            d_in, d_out = _resolve_dims(rule.layout,
                                        shape[1:] if L else shape)
            sites[ps] = _Site(path=ps, rule=rule, fmt=get_format(rule.format),
                              d_in=d_in, d_out=d_out, shape=shape,
                              dtype=leaf.dtype, L=L)
        return SparsityPlan(policy=self, sites=sites)


# ------------------------------------------------------------------ plan

class SparsityPlan:
    """A policy compiled against one param tree: ``prune`` → ``pack`` →
    ``matvec``.

    Attributes
    ----------
    policy : SparsityPolicy
        The declaration this plan was compiled from.
    sites : dict
        ``{path: _Site}`` for every matched param leaf.
    """

    def __init__(self, policy: SparsityPolicy, sites: dict):
        self.policy = policy
        self.sites = sites

    @property
    def activation(self):
        """The policy's temporal-delta rule (``DeltaGateConfig`` or
        None)."""
        return self.policy.activation

    @property
    def quant(self):
        """The policy's fixed-point rule (``QuantConfig`` or None)."""
        return self.policy.quant

    def __repr__(self):
        return f"SparsityPlan(sites={len(self.sites)})"

    def _site_mask(self, site: _Site, leaf) -> torch.Tensor:
        w = site.to_oi(leaf)
        opts = site.rule.options
        m = (torch.stack([site.fmt.mask(w[i], site.rule.ratio, **opts)
                          for i in range(site.L)]) if site.L else
             site.fmt.mask(w, site.rule.ratio, **opts))
        return site.from_oi(m)

    def masks(self, params) -> dict:
        """{path: bool mask} for every matched leaf (True = keep)."""
        return {ps: self._site_mask(self.sites[ps], leaf)
                for ps, leaf in _leaves_with_path(params)
                if ps in self.sites}

    def prune(self, params):
        """→ (pruned_params, masks)."""
        masks = self.masks(params)
        return apply_masks(params, masks), masks

    def apply_masks(self, params, masks):
        return apply_masks(params, masks)

    def mask_grads(self, grads, masks):
        return mask_grads(grads, masks)

    def pack(self, params, masks: dict | None = None,
             abstract: bool = False):
        """Replace every matched leaf with its packed-format rep.

        masks=None recomputes masks from the rule ratios. Pass the masks
        from ``prune`` to pack an exact pattern. A policy ``quant`` rule
        quantizes every row-balanced site on the way out (integer codes +
        per-row scales, counted by ``packed_bytes_q``). ``abstract=True``
        builds the formats' stand-ins (``meta`` tensors, for dry runs)
        from the leaves' shapes and dtypes alone: ``params`` may be
        ``meta`` tensors. A stacked site (``_Site.L``) packs each layer
        and stacks them. Returns (packed_params, report)."""
        qscheme = None
        if self.quant is not None:
            from ..quant import (abstract_quantize_packed, packed_bytes_q,
                                 parse_scheme, quantize_packed)
            qscheme = parse_scheme(getattr(self.quant, "scheme", self.quant))
        totals = dict(dense=0, packed=0)

        def one(ps, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            nbytes = leaf.numel() * leaf.element_size()
            totals["dense"] += nbytes
            site = self.sites.get(ps)
            if site is None:
                totals["packed"] += nbytes
                return leaf
            r, opts = site.rule.ratio, site.rule.options
            L1 = site.L or 1
            quantized = qscheme is not None and site.fmt.name == "row_balanced"
            if quantized:
                totals["packed"] += L1 * packed_bytes_q(site.d_out,
                                                        site.d_in, r, qscheme)
            else:
                totals["packed"] += L1 * site.fmt.packed_bytes(
                    site.d_out, site.d_in, r, leaf.dtype, **opts)
            if abstract:
                rep = site.fmt.abstract_pack(site.d_out, site.d_in, r,
                                             leaf.dtype, **opts)
                if quantized:
                    rep = abstract_quantize_packed(rep, qscheme)
                return site.fmt.abstract_stack(rep, site.L) if site.L else rep
            if masks is not None and ps in masks:
                m_oi = site.to_oi(masks[ps])
            else:
                m_oi = site.to_oi(self._site_mask(site, leaf))
            w_oi = site.to_oi(leaf)
            reps = [site.fmt.pack(w_oi[i] if site.L else w_oi,
                                  m_oi[i] if site.L else m_oi, **opts)
                    for i in range(L1)]
            reps = [quantize_packed(rep, qscheme) if quantized else rep
                    for rep in reps]
            return site.fmt.stack(reps) if site.L else reps[0]

        packed = _map_with_path(params, one)
        return packed, dict(dense_bytes=totals["dense"],
                            packed_bytes=totals["packed"],
                            ratio=totals["packed"] / max(totals["dense"], 1))

    def matvec(self, path: str, packed, x, *, backend: str | None = None):
        """One packed matvec through the site's format: x (B, d_in) →
        (B, d_out). ``backend`` as in ``sparse.backend`` (None: the
        process default)."""
        return self.sites[path].fmt.matvec(packed, x, backend=backend)

    def summary(self, masks: dict) -> dict:
        return sparsity_report(masks)


# -------------------------------------------------------- tree utilities

def apply_masks(params, masks: dict):
    """Zero pruned weights. masks: {path: bool mask}."""
    return _map_with_path(
        params, lambda ps, leaf: (torch.where(masks[ps], leaf,
                                              torch.zeros_like(leaf))
                                  if ps in masks else leaf))


def mask_grads(grads, masks: dict):
    """Freeze pruned weights by zeroing their gradients."""
    return apply_masks(grads, masks)


def sparsity_report(masks: dict) -> dict:
    total = pruned = 0
    for m in masks.values():
        total += m.numel()
        pruned += int(m.numel() - int(m.sum()))
    return {"prunable_params": total, "pruned": pruned,
            "sparsity": pruned / max(total, 1)}


# --------------------------------------------------------- stock policies

def lstm_policy(spar_x: float, spar_h: float, *,
                fmt: str = "row_balanced", delta=None,
                quant=None) -> SparsityPolicy:
    """The paper's dual-ratio split: input weights W_x at ``spar_x``,
    recurrent weights W_h at ``spar_h`` (both row-balanced by default).

    ``delta`` (a ``DeltaGateConfig``) is the temporal-delta activation
    rule serving wires into the LSTM's decode cache; ``quant`` (a
    ``QuantConfig``) makes ``pack`` emit integer codes + per-row scales so
    decode runs the q8 kernels.
    """
    return SparsityPolicy.of(
        {r"w_x$": (fmt, spar_x), r"w_h$": (fmt, spar_h)}, layout="out_in",
        activation=delta, quant=quant)


# (pattern, family, layout) — family A pruned at spar_a, B at spar_b. The
# port's per-layer paths (``layers/3/attn/wq``) match these as the
# reference's stacked ones (``blocks/0/attn/wq``) do.
_TRANSFORMER_FAMILIES = (
    (r"(mlp|moe)/w_(gate|up|down)$", "a", "in_out"),
    (r"rwkv/w_cm[12]$", "a", "in_out"),
    (r"(attn|xattn)/w[qkvo]$", "b", "in_out"),
    (r"rec/(w_in_gelu|w_in_rec|w_gate_a|w_gate_x|w_out)$", "b", "in_out"),
    (r"rwkv/w_[rkvgw]$", "b", "out_trailing"),
    (r"rwkv/w_out$", "b", "in_out"),
)


def transformer_policy(spar_a: float, spar_b: float, *,
                       fmt: str = "row_balanced") -> SparsityPolicy:
    """Dual-ratio families for the transformer zoo: family A (feed-forward,
    pruned harder) at ``spar_a``; family B (attention / recurrence mixers)
    at ``spar_b``. A 3-D attention weight takes the reference's (d_in,
    d_out) view: ``wq`` (d, H, Dh) under ``in_out`` is d_in = d·H, d_out =
    Dh, so each of its Dh rows keeps the same count."""
    rules = tuple(
        Rule(pat, fmt, spar_a if fam == "a" else spar_b, layout)
        for pat, fam, layout in _TRANSFORMER_FAMILIES)
    return SparsityPolicy(rules=rules)


def classify(path_str: str) -> str | None:
    """Family of a transformer param path ('a' | 'b' | None)."""
    for pat, fam, _ in _TRANSFORMER_FAMILIES:
        if re.search(pat, path_str):
            return fam
    return None
