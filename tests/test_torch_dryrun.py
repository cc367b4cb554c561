"""``launch.dryrun``: the production dry run, one rank of the 256- and
512-rank meshes traced on fake tensors, against the JAX reference.

* The bytes rank 0 holds of every zoo config's params and ZeRO-1 moments
  (at the train_4k cell's layout) and of its decode_32k cache (and params,
  at that cell's layout), on both production meshes: equal to the
  reference's ``shard_shape``s, which one subprocess computes on 512 forced
  host devices (its shardings only; nothing compiles).
* The CLI end to end at full width for qwen3-0.6b decode_32k on
  ``pod16x16``: ``ok`` and ``fits`` with every key of the record; a second
  run reads the JSON; ``--force`` traces again; ``--hlo-dir`` is refused.
* The grid's statuses: ``n/a`` exactly where the reference's ``runnable``
  is false; every other cell's path run by the port: every family's train
  cell tensor-parallel, every serving cell, the recurrent families' too.

Each test leaves no process group behind: the trace's fake group belongs
to this process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES, get_arch as jget_arch
from repro.configs import runnable as jrunnable
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch, runnable
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
MESHES = [False, True]
RECURRENT = {"recurrentgemma-9b", "rwkv6-7b"}
RECORD_KEYS = {"status", "memory", "flops_per_chip", "model_flops",
               "useful_flops_ratio", "collectives", "collective_wire_bytes",
               "hbm_bytes", "roofline", "trace_s"}

_REFERENCE = r'''
import json, sys
import numpy as np
from repro.configs import ARCH_NAMES, SHAPES, get_arch
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.serving.engine import cache_shardings
from repro.sharding import rules_for, use_rules
from repro.training import train_loop

def layout(arch, shape, n):
    # launch/dryrun.py's dp -> tp rule
    if arch.layout == "dp" and (
            shape.kind == "decode"
            or (shape.kind == "train" and shape.global_batch % n)
            or (shape.kind == "prefill" and not arch.moe)):
        return arch.with_(layout="tp")
    return arch

def held(shardings, tree, itemsize=None):
    import jax
    return int(sum(np.prod(s.shard_shape(t.shape))
                   * (itemsize or np.dtype(t.dtype).itemsize)
                   for s, t in zip(jax.tree.leaves(shardings),
                                   jax.tree.leaves(tree))))

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    n = 512 if multi else 256
    for name in ARCH_NAMES:
        rec = {}
        for cell in ("train_4k", "decode_32k"):
            arch = layout(get_arch(name), SHAPES[cell], n)
            model = build_model(arch)
            abs_ = model.abstract_params()
            with use_rules(rules_for(arch)):
                p_sh = train_loop.param_shardings(mesh, model)
                rec[cell] = {"params": held(p_sh, abs_)}
                if cell == "train_4k":
                    z = train_loop.zero1_shardings(mesh, p_sh, abs_)
                    rec[cell]["moments"] = 2 * held(z, abs_, 4)
                else:
                    c_sh = cache_shardings(mesh, model, 128, 32768)
                    rec[cell]["cache"] = held(
                        c_sh, model.cache_defs(128, 32768))
        out[f"{name}|{int(multi)}"] = rec
print(json.dumps(out))
'''


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_held():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    run = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi", MESHES, ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_held_bytes_match_reference_shard_shapes(reference_held, name,
                                                 multi):
    want = reference_held[f"{name}|{int(multi)}"]
    got_train = dryrun.held_bytes(name, "train_4k", multi)
    got_decode = dryrun.held_bytes(name, "decode_32k", multi)
    assert got_train == want["train_4k"]
    assert {k: got_decode[k] for k in ("params", "cache")} == \
        want["decode_32k"]


def test_cli_cell_end_to_end(tmp_path):
    """qwen3-0.6b decode_32k at full width on pod16x16 through the CLI: ok
    and fits, the record's keys; a rerun reads it; --force traces again;
    --hlo-dir is refused."""
    out = tmp_path / "dr"
    argv = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(out)]
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *argv], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "[OK ] qwen3-0.6b" in run.stdout and "1 ok" in run.stdout
    path = out / "qwen3-0.6b__decode_32k__pod16x16.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and RECORD_KEYS <= rec.keys()
    mem = rec["memory"]
    assert mem["fits"] and {"argument_bytes", "output_bytes",
                            "temp_bytes"} <= mem.keys()
    assert mem["held"]["cache"] == dryrun.held_bytes(
        "qwen3-0.6b", "decode_32k")["cache"]
    assert rec["flops_per_chip"]["kernels"]["decode_attention"]["calls"] \
        == get_arch("qwen3-0.6b").num_layers
    assert rec["flops_per_chip"]["aten"] > 0
    assert {c["kind"] for c in rec["collectives"].values()} == {
        "all-gather", "all-reduce"}
    assert rec["roofline"]["bound"] in ("compute", "memory", "collective")
    # a second run reads the record; --force traces the cell again
    stamp = path.stat().st_mtime_ns
    assert dryrun.main(argv) == 0
    assert path.stat().st_mtime_ns == stamp
    assert dryrun.main(argv + ["--force"]) == 0
    assert path.stat().st_mtime_ns != stamp
    assert json.loads(path.read_text())["memory"] == mem
    with pytest.raises(SystemExit):
        dryrun.main(argv + ["--hlo-dir", str(tmp_path / "hlo")])
    assert not (tmp_path / "hlo").exists()


def _cells():
    return [(a, s, m) for a in ARCH_NAMES for s in SHAPES for m in MESHES]


def test_grid_statuses_match_reference_and_roadmap(tmp_path):
    """n/a where the reference's runnable is false (each written as a
    record); every other cell's path run by the port: the train cells of
    every family (tensor-parallel where the layout splits their params),
    the serving cells, the recurrent families' too."""
    for arch, shape, multi in _cells():
        ok, reason = runnable(get_arch(arch), SHAPES[shape])
        assert (ok, reason) == jrunnable(jget_arch(arch), JSHAPES[shape])
        if not ok:
            rec = dryrun.run_cell(arch, shape, multi, str(tmp_path))
            assert (rec["status"], rec["reason"]) == ("n/a", reason)
            continue
        why = dryrun.refusal(arch, shape, multi)
        assert why is None, (arch, shape, multi, why)
    assert not dist.is_initialized() or dist.get_backend() == "fake"


def test_kv_quant_decode_is_not_ported():
    """--kv-quant: the split-KV decode holds the int8 cache of every
    family, the recurrent ones' too (recurrentgemma's local attention;
    rwkv6 holds none), on both meshes and at long_500k."""
    for arch in ("qwen3-0.6b", "granite-moe-1b-a400m", "seamless-m4t-medium",
                 "llava-next-34b"):
        assert dryrun.refusal(arch, "decode_32k", False,
                              {"kv_quant": True}) is None, arch
    for arch in sorted(RECURRENT):
        for shape in ("decode_32k", "long_500k"):
            for multi in MESHES:
                assert dryrun.refusal(arch, shape, multi,
                                      {"kv_quant": True}) is None, arch
    assert dryrun.refusal("qwen3-0.6b", "train_4k", False,
                          {"kv_quant": True}) is None


def test_brds_cell_packs_like_the_reference(tmp_path):
    """--brds: the abstract pack's report equal to the reference's under
    the config's ratios, the packed bytes a rank and the adjusted HBM
    term recorded, and the step not_ported (no transformer forward takes
    packed rows)."""
    from repro.models import build_model as jbuild
    from repro.sparse import transformer_policy as jpolicy
    arch = jget_arch("qwen3-0.6b")
    jabs = jbuild(arch).abstract_params()
    _, want = jpolicy(arch.brds.spar_a, arch.brds.spar_b).compile(
        jabs).pack(jabs, abstract=True)
    rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", False, str(tmp_path),
                          overrides={"brds": True})
    assert rec["status"] == "not_ported" and "packed rows" in rec["reason"]
    assert rec["brds"] == want
    dense = dryrun.held_bytes("qwen3-0.6b", "decode_32k")["params"]
    assert 0 < rec["packed_params_bytes"] < dense
    assert rec["hbm_bytes"]["brds_packed_ratio"] == want["ratio"]
