"""Meshes over ``torch.distributed`` ranks, and the launcher that starts the
ranks.

The reference is one JAX process over n devices; the port runs one process
a rank (SPMD): every rank runs the same program on replicated inputs and
meets the others only in collectives. A mesh is a DeviceMesh with named
dims (``make_mesh``), built over a process group that is already
initialized: by ``run_ranks``, which spawns ``data × model`` ranks with
``torch.multiprocessing`` and a ``FileStore`` under a directory of its own
(no TCP port, so concurrent test workers cannot collide), or by
``torchrun``.

The backend is explicit (``backend_for``): NCCL when every rank has a card
of its own, gloo on the CPU and when the caller asks for it on the card.
NCCL refuses two ranks on one card, so ranks that would share one under
NCCL raise here. Under gloo, collectives of card tensors are staged
through host memory (``dist.collective_ops``).

``make_production_mesh`` builds the reference's 16 × 16 pod (2 × 16 × 16
over two pods) over a group of exactly that many ranks, as ``torchrun``
starts them, one card a rank under NCCL; with ``backend="fake"`` over a
group of that many ranks on torch's "fake" backend (``init_fake_group``),
this process one rank of it, whose collectives return at once and move
no data: ``launch.dryrun`` runs a production cell's step as one such
rank on fake tensors, with no card and no other process.
"""
from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

__all__ = ["backend_for", "rank_device", "make_mesh", "make_host_mesh",
           "make_production_mesh", "init_fake_group", "run_ranks",
           "synced_clock"]

AXES = ("data", "model")


def backend_for(device, ranks: int, backend: str | None = None) -> str:
    """The process-group backend for ``ranks`` ranks on ``device``: gloo on
    the CPU; on the card NCCL unless ``backend`` asks for gloo. Raises
    where NCCL would put two ranks on one card. "fake" (``init_fake_group``)
    is taken as asked, on any device."""
    device = torch.device(device)
    if backend not in (None, "nccl", "gloo", "fake"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo' (or "
                         "'fake', a dry run's)")
    if backend == "fake":
        return backend
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs cards: a CPU mesh runs on gloo")
        return "gloo"
    backend = backend or "nccl"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if ranks > cards:
            raise ValueError(
                f"{ranks} ranks under NCCL need {ranks} cards, this machine "
                f"has {cards}: NCCL refuses two ranks on one card (ask for "
                "gloo to run them on the cards this machine has)")
    return backend


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: card ``rank mod cards`` for a card mesh (one
    card each under NCCL, shared under gloo), else ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def make_mesh(shape, axes=AXES, *, device="cpu", backend: str | None = None):
    """A DeviceMesh of ``shape`` with dims named ``axes`` over the
    initialized process group, whose backend must be ``backend_for``'s.
    On the card, this rank's device is set first (``rank_device``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch.mesh.run_ranks, or torchrun)")
    shape, axes = tuple(shape), tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh {dict(zip(axes, shape))} does not cover the "
                         f"{world} ranks of the process group")
    want = backend_for(device, world, backend)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have}, the mesh asks for "
                         f"{want}")
    device = torch.device(device)
    if device.type == "cuda" and have != "fake":
        torch.cuda.set_device(rank_device(device, dist.get_rank()))
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) gloo mesh of CPU ranks, for tests and CLI runs (over
    a process group of ``data × model`` gloo ranks)."""
    return make_mesh((data, model), AXES, device="cpu", backend="gloo")


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: str | None = None):
    """The reference's production mesh: 16 × 16 = 256 ranks, axes (data,
    model); two pods, 2 × 16 × 16 = 512, axes (pod, data, model). Over the
    initialized process group, which must hold exactly that many ranks
    (``torchrun --nproc-per-node ... --nnodes ...``); raises ValueError
    naming the ranks it needs otherwise. ``backend="fake"``: over a fake
    group of that many ranks, this process rank 0 (``init_fake_group``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    need = math.prod(shape)
    if backend == "fake":
        init_fake_group(need)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'pod'} mesh "
            f"{dict(zip(axes, shape))} needs {need} ranks, the process group "
            f"has {have}" + ("" if dist.is_initialized() else
                             " (none is initialized: start the ranks with "
                             "torchrun)"))
    return make_mesh(shape, axes, device=device,
                     backend=backend or dist.get_backend())


def init_fake_group(world: int, rank: int = 0) -> None:
    """Initialize the default process group on torch's "fake" backend:
    ``world`` ranks, this process rank ``rank``, every collective returning
    at once and moving no data. A fake group of another size or rank is
    replaced; a real one is refused (RuntimeError)."""
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               "initialized: a fake one cannot replace it")
        if (dist.get_world_size(), dist.get_rank()) == (world, rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _rank_entry(rank, fn, shape, device, backend, args, workdir, threads,
                timeout):
    if threads:
        torch.set_num_threads(threads)
    world = math.prod(shape)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(shape, AXES, device=device, backend=backend)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, data: int, model: int, *, device="cpu",
              backend: str | None = None, args: tuple = (),
              workdir: str | None = None, threads: int | None = 1,
              timeout: float = 300.0) -> list:
    """Run ``fn(mesh, *args)`` on ``data × model`` spawned ranks, one
    process each, over a (data, model) mesh; return their results in rank
    order. ``fn`` must be importable by name (a module-level function) and
    return something ``torch.save`` takes. The ranks meet through a
    FileStore in a fresh directory under ``workdir`` (the temporary
    directory when None), removed at the end. ``threads``: torch threads
    a rank (None: torch's default). ``timeout``: seconds a collective may
    wait. A rank that raises ends every rank and raises here."""
    import torch.multiprocessing as mp
    shape = (data, model)
    backend = backend_for(device, data * model, backend)
    tmp = tempfile.mkdtemp(prefix="mesh-", dir=workdir)
    try:
        mp.start_processes(_rank_entry,
                           args=(fn, shape, str(device), backend, args, tmp,
                                 threads, timeout),
                           nprocs=data * model, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(data * model)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synced_clock(clock=time.perf_counter):
    """A clock whose every reading is rank 0's, broadcast over the default
    group, so host decisions made from it (admission, deadlines, a trace's
    arrivals) agree on every rank. Each reading is a collective: every rank
    must read it as often, in the same order."""
    def read() -> float:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([clock()], dtype=torch.float64, device=dev)
        dist.broadcast(t, src=0)
        return float(t)
    return read
