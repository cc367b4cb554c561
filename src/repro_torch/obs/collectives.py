"""Per-step collective inventory of sharded serving (``repro_torch.dist``).

``repro_torch.dist`` claims exactly one collective a decode step and layer:
the all-gather of the sharded hidden state h over the ``model`` axis. This
module makes the claim measurable: it runs a step once under
``torch.profiler`` and counts the ``torch.distributed`` (c10d) collectives
that step issued, by kind, with the bytes each rank sent where the
backend's own event carries them (``gloo:*`` / ``nccl:*``).

The reference reads the collectives out of compiled HLO
(``inventory_from_text``), which has no counterpart here, as nothing
compiles to HLO. ``top`` reports a dry-run cell's top contributors from
the collectives its traced step stages (``launch.dryrun.build_cell``).
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
    profiler event: ``shapes()`` and ``dtypes()``), where recorded (a 0-d
    tensor's shape is empty: one element)."""
    shapes, dtypes = event.shapes(), event.dtypes()
    if not shapes or not dtypes:
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
    """Print the top collective contributors (bytes × multiplicity) of one
    ``launch.dryrun`` cell, traced as rank 0 of its mesh; returns the
    inventory records, the reference's keys: one a site (a kind over a
    mesh axis at one payload), ``mult`` its count in the step, ``bytes``
    its payload, ``wire_bytes`` bytes × mult, largest first."""
    from .. import hw
    from ..launch.dryrun import build_cell
    tr = build_cell(arch, shape, multi, overrides)
    sites: dict = {}
    for r in tr["collectives"]:
        key = (r["kind"], r["axis"], r["bytes"], len(r["ranks"]))
        link = ("NVLink" if hw.link_bw(r["ranks"]) == hw.NVLINK_BW
                else "InfiniBand")
        it = sites.setdefault(key, {
            "kind": r["kind"], "mult": 0, "bytes": r["bytes"],
            "wire_bytes": 0,
            "where": f"{r['kind']} over {r['axis']} "
                     f"({len(r['ranks'])} ranks, {link})"})
        it["mult"] += 1
        it["wire_bytes"] += r["bytes"]
    items = sorted(sites.values(), key=lambda it: -it["wire_bytes"])
    total = sum(it["wire_bytes"] for it in items)
    print(f"total payload×mult: {total:.3e} bytes/chip "
          f"(~{total / hw.IB_BW * 1e3:.0f} ms at InfiniBand)")
    for it in items[:n]:
        print(f"{it['wire_bytes']:.2e}  mult={it['mult']:5.0f} "
              f"size={it['bytes']:.2e} {it['kind']:13s} "
              f"{it['where'][-90:]}")
    return items
