"""Per-step collective inventory of sharded serving (``repro_torch.dist``).

``repro_torch.dist`` claims exactly one collective a decode step and layer:
the all-gather of the sharded hidden state h over the ``model`` axis. This
module makes the claim measurable: it runs a step once under
``torch.profiler`` and counts the ``torch.distributed`` (c10d) collectives
that step issued, by kind, with the bytes each rank sent where the
backend's own event carries them (``gloo:*`` / ``nccl:*``).

The reference reads the collectives out of compiled HLO
(``inventory_from_text``) and reports a dry-run cell's top contributors
(``top``); neither has a counterpart here, as nothing compiles to HLO.
"""
from __future__ import annotations

import math

__all__ = ["inventory_from_text", "inventory", "decode_step_inventory",
           "summarize_inventory", "top"]

# c10d op (without "c10d::" and the trailing "_") → the reference's kind
_KINDS = {"allgather": "all-gather", "_allgather_base": "all-gather",
          "allgather_into_tensor_coalesced": "all-gather",
          "allgather_coalesced": "all-gather",
          "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
          "reduce_scatter": "reduce-scatter",
          "_reduce_scatter_base": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "alltoall": "all-to-all", "alltoall_base": "all-to-all",
          "broadcast": "broadcast", "reduce": "reduce", "gather": "gather",
          "scatter": "scatter", "send": "send", "recv": "recv",
          "recv_any_source": "recv", "barrier": "barrier"}
# the backends' own events ("gloo:all_gather") → the same kinds
_BACKEND_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                  "reduce_scatter": "reduce-scatter",
                  "all_to_all": "all-to-all", "broadcast": "broadcast",
                  "reduce": "reduce", "gather": "gather",
                  "scatter": "scatter", "send": "send", "recv": "recv",
                  "barrier": "barrier"}


def _kind(name: str) -> str | None:
    if name.startswith("c10d::"):
        return _KINDS.get(name[len("c10d::"):].rstrip("_"))
    return None


# the profiler's dtype names → bytes an element
_ITEMSIZE = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
             "int": 4, "long int": 8, "short int": 2, "signed char": 1,
             "unsigned char": 1, "bool": 1}


def _backend_bytes(event) -> int | None:
    """Bytes of the first input of a backend's collective event (a raw
    profiler event: ``shapes()`` and ``dtypes()``), where recorded."""
    shapes, dtypes = event.shapes(), event.dtypes()
    if not shapes or not shapes[0] or not dtypes:
        return None
    itemsize = _ITEMSIZE.get(dtypes[0])
    return None if itemsize is None else math.prod(shapes[0]) * itemsize


def inventory_from_text(text: str) -> list[dict]:
    """The reference's HLO reader: no counterpart (nothing compiles to HLO
    here; ``inventory`` measures a step instead)."""
    raise NotImplementedError(
        "inventory_from_text reads compiled HLO, which the port has none "
        "of: take a step's inventory with obs.collectives.inventory")


def inventory(fn, *args, **kwargs) -> list[dict]:
    """The collectives ``fn(*args, **kwargs)`` issues, run once under
    torch.profiler on this rank: one record a collective in issue order,
    ``kind`` (the reference's names: "all-gather", "all-reduce", ...),
    ``mult`` 1, ``bytes`` this rank's payload (None where the backend's
    event lacks it), ``wire_bytes`` the same and ``where`` the c10d op."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn(*args, **kwargs)
    # the raw events carry every op's input dtypes on every torch version
    events = sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns())
    sizes: dict[str, list] = {}
    for e in events:
        backend, _, op = e.name().partition(":")
        if backend in ("gloo", "nccl") and op in _BACKEND_KINDS:
            sizes.setdefault(_BACKEND_KINDS[op], []).append(
                _backend_bytes(e))
    items, used = [], {}
    for e in events:
        kind = _kind(e.name())
        if kind is None:
            continue
        i = used.get(kind, 0)
        used[kind] = i + 1
        got = sizes.get(kind, [])
        nbytes = got[i] if i < len(got) else None
        items.append({"kind": kind, "mult": 1, "bytes": nbytes,
                      "wire_bytes": nbytes, "where": e.name()})
    return items


def decode_step_inventory(model, params, cache, tokens, pos) -> list[dict]:
    """Inventory of ONE ``model.decode_step``: the collective bill a
    sharded decode pays every token."""
    return inventory(model.decode_step, params, cache, tokens, pos)


def summarize_inventory(items: list[dict]) -> dict:
    """{kind: count} plus the ``wire_bytes`` total (None when a record
    lacks its bytes): the shape tests assert on (exactly ``num_layers``
    all-gathers a step)."""
    by_kind: dict[str, int] = {}
    for it in items:
        by_kind[it["kind"]] = by_kind.get(it["kind"], 0) + it["mult"]
    wire = [it["wire_bytes"] for it in items]
    return {"counts": by_kind,
            "wire_bytes": None if None in wire else sum(wire)}


def top(arch, shape, multi=False, n=10, overrides=None):
    """The reference's report of a dry-run cell's top collectives: no
    counterpart (the dry run is not ported)."""
    raise NotImplementedError(
        "top reports a launch.dryrun cell's collectives from compiled HLO; "
        "the port has no dry run (ROADMAP.md, queue A item 6) and no HLO")
