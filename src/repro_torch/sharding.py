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

``named_sharding`` pairs a mesh with those placements (the counterpart of
the reference's ``NamedSharding``: what the training shardings, a
checkpoint's ``restore(shardings=)`` and ``dist.shard_local`` read), and
``spec_tree`` maps it over matching trees of logical axes and shapes.
``constrain`` redistributes a DTensor to the placements its logical axes
resolve to; on a plain tensor it is the identity, as the reference's is a
no-op outside a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = ["DEFAULT_RULES", "dp_rules", "rules_for", "use_rules",
           "active_rules", "mesh_axes", "resolve_spec", "placements",
           "spec_placements", "NamedSharding", "named_sharding",
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


def spec_placements(mesh, spec: Sequence) -> tuple:
    """The DTensor placements, one a mesh dim, of partition entries
    ``spec`` (``resolve_spec``'s form): ``Shard(d)`` on every mesh axis
    that tensor dim d names, ``Replicate()`` elsewhere. A dim named by
    several axes is split by them in mesh order, as the reference's joint
    axes are."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[ax] = d
    return tuple(Shard(owner[ax]) if ax in owner else Replicate()
                 for ax in mesh_axes(mesh))


def placements(mesh, logical: Sequence[str | None], shape: Sequence[int],
               rules: dict | None = None) -> tuple:
    """The DTensor placements, one a mesh dim, that ``resolve_spec``
    implies: ``Shard(d)`` where tensor dim d resolved to that mesh axis,
    ``Replicate()`` elsewhere."""
    return spec_placements(mesh, resolve_spec(mesh, logical, shape, rules))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the DTensor placements of a tensor over it, one a mesh
    dim (the reference's ``NamedSharding``); ``spec`` keeps the partition
    entries they came from."""
    mesh: object
    placements: tuple
    spec: tuple = ()


def named_sharding(mesh, logical: Sequence[str | None], shape: Sequence[int],
                   rules: dict | None = None) -> NamedSharding:
    spec = resolve_spec(mesh, logical, shape, rules)
    return NamedSharding(mesh, spec_placements(mesh, spec), spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def spec_tree(mesh, logical_tree, shape_tree, rules: dict | None = None):
    """``named_sharding`` over matching trees (dicts and lists) of logical
    axis tuples and shapes: a tree of ``NamedSharding``."""
    if _is_axes(logical_tree):
        return named_sharding(mesh, logical_tree, tuple(shape_tree), rules)
    if isinstance(logical_tree, dict):
        return {k: spec_tree(mesh, v, shape_tree[k], rules)
                for k, v in logical_tree.items()}
    return type(logical_tree)(spec_tree(mesh, v, s, rules)
                              for v, s in zip(logical_tree, shape_tree))


def constrain(x, *logical, rules: dict | None = None):
    """Redistribute the DTensor ``x`` to the placements its ``logical``
    axes resolve to over its own mesh (the reference's
    with_sharding_constraint by logical axes). The identity on a plain
    tensor: outside a mesh there is nothing to constrain."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(mesh, logical, x.shape, rules)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


class Axes(tuple):
    """A logical-axes annotation: Axes('embed', 'mlp')."""
    __slots__ = ()

    def __new__(cls, *names):
        return super().__new__(cls, names)
