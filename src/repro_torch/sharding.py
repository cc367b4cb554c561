"""Logical-axis sharding rules (MaxText-style), divisibility-aware.

The port's copy of the reference's rule table. Every parameter / activation
dimension carries a *logical* axis name ('batch', 'embed', 'heads', 'mlp',
'experts', 'vocab', ...). A rule table maps logical names to candidate
physical mesh axes in priority order; the resolver picks, per tensor
dimension, the first candidate whose mesh-axis product divides the dim size
and whose physical axes are not already taken by another dimension of the
same tensor. Non-divisible dims degrade to replication instead of erroring.

``resolve_spec`` returns a tuple with one entry a tensor dim (None, a mesh
axis name, or a tuple of names), the entries of the reference's
``PartitionSpec``; ``placements`` turns it into the DTensor placements
(``Shard(dim)`` / ``Replicate()`` a mesh dim) that ``repro_torch.dist``
lays packed rows out with. A mesh is a ``torch.distributed`` DeviceMesh
(``mesh_dim_names`` and ``shape``) or anything with the reference mesh's
``axis_names`` and ``devices.shape``.

``spec_tree`` and ``constrain`` serve the GSPMD-style training shardings,
which come with the training half of the sharded port (ROADMAP.md, queue A
item 7, slice 19).
"""
from __future__ import annotations

import math
from typing import Sequence

__all__ = ["DEFAULT_RULES", "dp_rules", "rules_for", "use_rules",
           "active_rules", "mesh_axes", "resolve_spec", "placements",
           "spec_tree", "constrain", "Axes"]

# logical name -> candidate physical axes, priority ordered. Each candidate
# is a tuple of mesh axis names (joint sharding) or None (replicate).
DEFAULT_RULES: dict[str, list] = {
    "batch":     [("pod", "data"), ("data",), None],
    "seq":       [None],
    # KV caches are sequence-sharded over the model axis (split-KV /
    # flash-decode)
    "cache_seq": [("model",), None],
    "embed":     [None],
    # head_dim is never sharded: within-head splits force per-layer
    # activation all-gathers
    "heads":     [("model",), None],
    "kv_heads":  [("model",), None],
    "head_dim":  [None],
    "qkv":       [("model",), None],     # flattened q/k/v output dim
    "mlp":       [("model",), None],
    "experts":   [("model",), None],
    "expert_cap": [None],
    "vocab":     [("model",), None],
    "layers":    [None],                  # stacked leading dim
    "lstm_gates": [("model",), None],     # the LSTM 4H gate dim
    "lstm_hidden": [None],
    # the row dim of a packed RowBalancedSparse[Q8] (values, deltas,
    # scales and bias move together; every row holds exactly NZ
    # survivors, so a row split is load-balanced by construction)
    "packed_rows": [("model",), None],
    # the sharded decode cache's hidden slice: c shards with the gate rows
    # it is updated from, while h stays replicated ("lstm_hidden")
    "lstm_hidden_shard": [("model",), None],
    "conv":      [None],
    "zero":      [("data",), None],       # ZeRO-1 optimizer-state dim
}

_ACTIVE_RULES: list = []


def dp_rules() -> dict:
    """The "dp" layout: the model axis folds into data parallelism (small
    models, where tensor-parallel all-reduces cost more than replicated
    weights)."""
    r = dict(DEFAULT_RULES)
    r["batch"] = [("pod", "data", "model"), ("data", "model"),
                  ("pod", "data"), ("data",), None]
    for name in ("heads", "kv_heads", "mlp", "experts", "vocab",
                 "lstm_gates", "cache_seq"):
        r[name] = [None]
    return r


def rules_for(cfg) -> dict:
    """Config → rule table (``cfg.layout``: 'tp', the default, or 'dp')."""
    if getattr(cfg, "layout", "tp") == "dp":
        return dp_rules()
    return DEFAULT_RULES


class use_rules:
    """Context manager: overrides the rule table that resolve calls with
    ``rules=None`` see."""

    def __init__(self, rules: dict | None):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *a):
        _ACTIVE_RULES.pop()


def active_rules() -> dict | None:
    return _ACTIVE_RULES[-1] if _ACTIVE_RULES else None


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mesh with ``axis_names``
    and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_spec(mesh, logical: Sequence[str | None], shape: Sequence[int],
                 rules: dict | None = None,
                 extra_taken: Sequence[str] = ()) -> tuple:
    """Resolve a logical axis tuple to the partition entries for ``mesh``:
    one entry a dim, None (replicated), an axis name or a tuple of them."""
    rules = rules or active_rules() or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    taken: set[str] = set(extra_taken)
    out = []
    for name, dim in zip(logical, shape):
        if name is None:
            out.append(None)
            continue
        pick = None
        for cand in rules.get(name, [None]):
            if cand is None:
                break
            axes = tuple(a for a in cand if a in sizes)
            if not axes:
                continue
            prod = math.prod(sizes[a] for a in axes)
            if dim % prod == 0 and not (set(axes) & taken):
                pick = axes
                taken.update(axes)
                break
        out.append(pick if pick is None else
                   (pick if len(pick) > 1 else pick[0]))
    return tuple(out)


def placements(mesh, logical: Sequence[str | None], shape: Sequence[int],
               rules: dict | None = None) -> tuple:
    """The DTensor placements, one a mesh dim, that ``resolve_spec``
    implies: ``Shard(d)`` where tensor dim d resolved to that mesh axis,
    ``Replicate()`` elsewhere (the counterpart of the reference's
    ``named_sharding``)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = resolve_spec(mesh, logical, shape, rules)
    owner = {}
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[ax] = d
    return tuple(Shard(owner[ax]) if ax in owner else Replicate()
                 for ax in mesh_axes(mesh))


def spec_tree(mesh, logical_tree, shape_tree, rules: dict | None = None):
    """The reference's tree of NamedShardings: the GSPMD-style training
    shardings, not ported yet."""
    raise NotImplementedError(
        "sharding.spec_tree serves the GSPMD-style parameter, optimizer and "
        "batch shardings of sharded training, which come in slice 19 "
        "(ROADMAP.md, queue A item 7, the training half)")


def constrain(x, *logical, rules: dict | None = None):
    """The reference's with_sharding_constraint by logical axes: not
    ported yet."""
    raise NotImplementedError(
        "sharding.constrain (a sharding constraint inside a traced step) "
        "serves sharded training and the transformers' split-KV decode, "
        "which come in slice 19 (ROADMAP.md, queue A item 7)")


class Axes(tuple):
    """A logical-axes annotation: Axes('embed', 'mlp')."""
    __slots__ = ()

    def __new__(cls, *names):
        return super().__new__(cls, names)
