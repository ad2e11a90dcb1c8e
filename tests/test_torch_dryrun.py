"""The port's dry-run (``repro_torch.launch.dryrun``, ``hlo_analysis``,
``report``) against the reference's, on the CPU.

The step cost analyzer's counterparts of ``tests/test_dryrun.py``'s
analyzer tests run here. The reference's numbers come from a subprocess,
because importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for the
process; the port's fake worlds run in another, because the fake process
group is process-global. Both subprocesses start together once per
module.
"""

import functools
import json
import math
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as jhlo
from repro.launch import report as jreport
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke
from repro_torch.distributed.sharding import (
    P,
    batch_pspec,
    cache_pspecs,
    dp_axes,
    param_pspecs,
)
from repro_torch.kernels.flash_decode import (
    _check_shapes,
    flash_decode,
    flash_decode_plain,
)
from repro_torch.launch import report as treport
from repro_torch.launch.hlo_analysis import (
    COLLECTIVE_OPS,
    StepCost,
    analyze_step,
    ring_bytes,
)
from repro_torch.models import transformer

REPO = pathlib.Path(__file__).parent.parent

# the reference's model FLOPs and active parameters of every cell, and its
# one-device compile of the smoke llama3-8b at its smoke test's shapes
_REF = r"""
import json
import jax
import repro.launch.dryrun as D
import repro.launch.mesh as M
import repro.configs as C
import repro.configs.llama3_8b as L
out = {"model_flops": {a: {s: D.model_flops(C.get_config(a), s)
                           for s in C.SHAPES} for a in C.ARCH_IDS},
       "active_params": {a: D.active_params(C.get_config(a))
                         for a in C.ARCH_IDS}}
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (1, 1), ("data", "model"), **M._axis_types_kwargs(2))
D.SHAPES = C.SHAPES = {
    "train_4k": C.ShapeSpec("train_4k", 64, 8, "train"),
    "decode_32k": C.ShapeSpec("decode_32k", 64, 8, "decode")}
cfgs = {"llama3-8b": L.smoke().replace(loss_chunk=16)}
D.get_config = lambda a: cfgs[a]
out["one_device"] = {}
for shape in ("train_4k", "decode_32k"):
    r = D.run_cell("llama3-8b", shape, "single", verbose=False)
    assert r["ok"], r.get("error")
    out["one_device"][shape] = r["hlo_flops"]
print(json.dumps(out))
"""

# the port: importing the dry-run; a redistribute of each collective kind
# on a 4-rank fake mesh; the smoke llama3-8b on a one-rank mesh and on the
# reference smoke test's (4, 4) and (2, 2, 4) meshes; the CLI
_PORT = r"""
import json, math, os, sys
env = dict(os.environ)
import torch.distributed as dist
import repro_torch.launch.dryrun as D
out = {"env_unchanged": dict(os.environ) == env,
       "group_after_import": dist.is_initialized()}
import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.hlo_analysis import analyze_step
import repro_torch.configs as C
import repro_torch.configs.llama3_8b as L

with D.fake_world(4):
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    group = mesh.get_group()
    moves = {"all-gather": ([Shard(0)], [Replicate()]),
             "all-reduce": ([Partial()], [Replicate()]),
             "reduce-scatter": ([Partial()], [Shard(0)])}
    coll = {}
    with FakeTensorMode():
        for kind, (src, dst) in moves.items():
            local = torch.empty((4, 8) if src[0].is_shard() else (16, 8))
            x = DTensor.from_local(local, mesh, src, run_check=False,
                                   shape=(16, 8), stride=(8, 1))
            cost, _ = analyze_step(
                lambda t: t.redistribute(mesh, dst).to_local(), x)
            coll[kind] = cost
        x = torch.empty(16, 8)
        coll["all-to-all"], _ = analyze_step(lambda: funcol.wait_tensor(
            funcol.all_to_all_single(x, None, None, group)))
    real = torch.ones(16, 8)
    coll["c10d all-reduce"], _ = analyze_step(
        lambda: dist.all_reduce(real, group=group))
    coll["collective-permute"], _ = analyze_step(
        lambda: dist.send(real, dst=1, group=group))
out["collectives"] = {k: {"collectives": v["collectives"],
                          "groups": v["collective_groups"],
                          "warnings": v["warnings"]}
                      for k, v in coll.items()}

D.SHAPES = {"train_4k": C.ShapeSpec("train_4k", 64, 8, "train"),
            "decode_32k": C.ShapeSpec("decode_32k", 64, 8, "decode")}
cfgs = {"llama3-8b": L.smoke().replace(loss_chunk=16)}
D.get_config = lambda a: cfgs[a]


# the production meshes replaced by smaller ones (and the fake worlds by
# their sizes), as the reference's smoke test replaces them
def use_meshes(single, multi):
    D.MESH_RANKS = {"single": math.prod(single[0]),
                    "multi": math.prod(multi[0])}

    def make(multi_pod=False, device=None):
        shape, names = multi if multi_pod else single
        return DeviceMesh(device, torch.arange(math.prod(shape)).reshape(
            shape), mesh_dim_names=names)
    D.make_production_mesh = make


out["cells"] = {}
one = ((1, 1), ("data", "model"))
use_meshes(one, one)
for shape in ("train_4k", "decode_32k"):
    out["cells"]["one", shape] = D.run_cell("llama3-8b", shape, "single",
                                            verbose=False, device="cpu")
use_meshes(((4, 4), ("data", "model")),
           ((2, 2, 4), ("pod", "data", "model")))
for shape in ("train_4k", "decode_32k"):
    for m in ("single", "multi"):
        out["cells"][m, shape] = D.run_cell("llama3-8b", shape, m,
                                            verbose=False, device="cpu")
out["cells"] = {"/".join(k): v for k, v in out["cells"].items()}
D.main(["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "both",
        "--device", "cpu", "--out", sys.argv[1]])
print(json.dumps(out))
"""


def _start(script, *argv):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.Popen([sys.executable, "-c", script, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, port, cli_dir)``: both subprocesses, run together."""
    cli = tmp_path_factory.mktemp("dryrun_cli")
    ref, port = _start(_REF), _start(_PORT, str(cli))
    return _result(ref), _result(port), cli


# ----------------------------------------------- the analyzer (TestHloAnalyzer)
def test_loop_free_flops_match_closed_form_and_flop_counter():
    g = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(s, generator=g)
                 for s in [(64, 128), (128, 256), (256, 512)])
    counter = FlopCounterMode(display=False)
    with counter:
        mine, _ = analyze_step(lambda a, b, c: ((a @ b) @ c).sum(),
                               x, w1, w2)
    exact = 2 * 64 * 128 * 256 + 2 * 64 * 256 * 512
    assert abs(mine["flops"] - exact) / exact < 0.01       # 1 %, as TestHloAnalyzer
    assert mine["flops"] == counter.get_total_flops()      # exact
    # bytes: each op's operands and output once (two products, one sum)
    assert mine["bytes"] == 4 * (64 * 128 + 128 * 256 + 64 * 256
                                 + 64 * 256 + 256 * 512 + 64 * 512
                                 + 64 * 512 + 1)


def _layers(x, ws):
    for i in range(ws.shape[0]):
        x = torch.nn.functional.gelu(x @ ws[i])
    return x.sum()


def test_python_loop_flops_counted_per_layer():
    x, ws = torch.randn(64, 128), torch.randn(32, 128, 128)
    mine, _ = analyze_step(_layers, x, ws)
    exact = 32 * 2 * 64 * 128 * 128
    assert abs(mine["flops"] - exact) / exact < 0.01       # 1 %


def test_loop_bytes_not_inflated_by_stacked_params():
    # a loop reading one (128, 128) slice per step must not count the
    # whole (32, 128, 128) stack per iteration (TestHloAnalyzer's bound)
    x, ws = torch.randn(64, 128), torch.randn(32, 128, 128)
    mine, _ = analyze_step(_layers, x, ws)
    upper = 32 * (6 * 64 * 128 + 3 * 128 * 128) * 4
    assert mine["bytes"] < upper


def test_products_with_a_positional_out_dtype_are_counted():
    """``bmm.dtype`` (the MoE's f32-out products on the card): torch's
    stock formula reads the dtype as the output's shape and raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import flop_counter
    a = torch.randn(2, 3, 4, dtype=torch.bfloat16)
    b = torch.randn(2, 4, 5, dtype=torch.bfloat16)
    with FakeTensorMode() as mode:
        a, b = mode.from_tensor(a), mode.from_tensor(b)
        with flop_counter() as counter:
            cost, out = analyze_step(torch.ops.aten.bmm.dtype, a, b,
                                     torch.float32)
    assert out.dtype == torch.float32
    assert cost["flops"] == counter.get_total_flops() == 2 * 2 * 3 * 4 * 5


def test_grad_flops_ratio():
    w, x = torch.randn(256, 256), torch.randn(64, 256)

    def fwd(w, x):
        return ((x @ w) ** 2).sum()

    def grad(w, x):
        w = w.detach().requires_grad_()
        with torch.enable_grad():
            return torch.autograd.grad(fwd(w, x), w)[0]

    f, _ = analyze_step(fwd, w, x)
    b, _ = analyze_step(grad, w, x)
    assert 1.5 <= b["flops"] / f["flops"] <= 3.5


def test_memory_follows_saved_activations_and_frees():
    """Live bytes: the arguments, every storage an op returns while
    something (the autograd graph included) holds it, nothing after."""
    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(32, 64)
    with StepCost() as cost:
        args = cost.arguments((w, x))
        y = torch.sin(x @ w)            # the product saved, y held
        after_fwd = cost.live_bytes
        loss = y.sum()
        loss.backward()
        del y, loss
        after_bwd = cost.live_bytes
    assert args == 4 * (64 * 64 + 32 * 64)
    assert after_fwd == args + 2 * 4 * 32 * 64
    # the gradient of w is alive, the activations are freed
    assert after_bwd == args + 4 * 64 * 64
    assert cost.peak_bytes >= after_fwd


def test_memory_alias_bytes_are_donated_arguments():
    p, g = torch.randn(1000), torch.randn(1000)

    def step(p, g):
        p.sub_(g)                       # donated: updated in place
        return p, g.sum()

    cost, _ = analyze_step(step, p, g)
    assert cost["memory"] == {"argument_bytes": 8000, "output_bytes": 4004,
                              "peak_bytes": 8004, "alias_bytes": 4000}


# ------------------------------------------------------------ the ring model
def _ref_instr(kind: str, out_type: str, g: int):
    return jhlo.Instr("c", out_type, kind,
                      f"%p), channel_id=1, replica_groups=[{64 // g},{g}]"
                      f"<=[64], dimensions={{0}}")


@pytest.mark.parametrize("kind", COLLECTIVE_OPS)
@pytest.mark.parametrize("g", [1, 4, 16])
def test_ring_bytes_are_the_references(kind, g):
    ref = jhlo.HloCost("")
    for out_type, nbytes in (("f32[64,128]", 4 * 64 * 128),
                             ("bf16[16,4096]", 2 * 16 * 4096)):
        assert ring_bytes(kind, nbytes, g) == ref._collective(
            _ref_instr(kind, out_type, g))


_MOVES = {"all-gather": 512 * 3 / 4, "all-reduce": 2 * 512 * 3 / 4,
          "reduce-scatter": 128 * 3, "all-to-all": 512 * 3 / 4,
          "c10d all-reduce": 2 * 512 * 3 / 4, "collective-permute": 512}


@pytest.mark.parametrize("case", sorted(_MOVES))
def test_collectives_on_a_4_rank_fake_mesh(runs, case):
    """A (16, 8) f32 tensor moved by DTensor (all-gather, all-reduce,
    reduce-scatter), by ``all_to_all_single``, and by ``c10d``'s
    ``all_reduce`` and ``send``: one op of its kind over the four ranks,
    the ring model's bytes."""
    got = runs[1]["collectives"][case]
    kind = case.replace("c10d ", "")
    assert got["collectives"] == {kind: {"count": 1, "bytes": _MOVES[case]}}
    assert got["groups"] == [{"ranks": [0, 1, 2, 3], "size": 4, "count": 1,
                              "bytes": _MOVES[case]}]
    assert got["warnings"] == []


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_are_the_references(runs, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import active_params, model_flops
    ref = runs[0]
    cfg = get_config(arch)
    assert active_params(cfg) == ref["active_params"][arch]       # exact
    for s in SHAPES:
        assert model_flops(cfg, s) == ref["model_flops"][arch][s]  # exact


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_one_rank_flops_near_the_references_one_device_compile(runs, shape):
    """The smoke llama3-8b (``loss_chunk=16``) at the reference smoke
    test's shapes (64 x 8): the port's per-rank FLOPs on a one-rank mesh
    against ``analyze_hlo`` of the reference's one-device compile. Seen:
    ratio 1.0 for both (the same products; B8's 4 B H S D stands for the
    reference's attention dots at decode)."""
    cell = runs[1]["cells"][f"one/{shape}"]
    assert cell["ok"], cell.get("error")
    ratio = cell["hlo_flops"] / runs[0]["one_device"][shape]
    assert abs(ratio - 1) < 0.05, ratio                           # 5 %


def _local_bytes(metas, specs, sizes) -> int:
    """Closed form: each leaf's bytes divided by the sizes of the mesh
    axes its spec shards it over (the tables shard only dims they
    divide)."""
    total = 0
    for path, t in tree.leaves_with_path(metas):
        spec = functools.reduce(lambda node, key: node[key], path, specs)
        div = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                div *= sizes.get(a, 1)
        total += t.numel() * t.element_size() // div
    return total


_SMOKE_MESHES = {"single": {"data": 4, "model": 4},
                 "multi": {"pod": 2, "data": 2, "model": 4}}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_smoke_cells_on_reduced_meshes(runs, mesh, shape):
    """``SMOKE_DRYRUN``'s counterpart over a fake world of 16: the (4, 4)
    and (2, 2, 4) meshes, the smoke llama3-8b at (64, 8); every cell ok,
    FLOPs counted, a dominant term, and the argument bytes the closed
    form of the local shards the tables lay out (parameters, AdamW state
    and batch for training; parameters, cache and tokens for decode)."""
    r = runs[1]["cells"][f"{mesh}/{shape}"]
    assert r["ok"], r.get("error")
    assert r["n_devices"] == 16 and r["hlo_flops"] > 0
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    assert r["flop_counter_flops"] > 0 and not r["warnings"]
    cfg = get_smoke("llama3-8b").replace(loss_chunk=16)
    sizes = _SMOKE_MESHES[mesh]
    view = SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
    pshape = transformer.param_specs(cfg)
    spec = SHAPES[shape]
    b, s = 8, 64
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    if spec.kind == "train":
        ps = param_pspecs(cfg, view, pshape, "fsdp_tp")
        f32 = tree.tree_map(lambda t: torch.empty(
            t.shape, dtype=torch.float32, device="meta"), pshape)
        bp = batch_pspec(view)
        want = (_local_bytes(pshape, ps, sizes)
                + 2 * _local_bytes(f32, ps, sizes) + 4      # m, v, step
                + _local_bytes([tok, tok], [bp["tokens"], bp["labels"]],
                               sizes))
    else:
        ps = param_pspecs(cfg, view, pshape, "tp")
        cache = transformer.init_cache(cfg, b, s, device="meta")
        toks = torch.empty((b,), dtype=torch.int32, device="meta")
        want = (_local_bytes(pshape, ps, sizes)
                + _local_bytes(cache, cache_pspecs(cfg, view, cache), sizes)
                + _local_bytes([toks], [P(dp_axes(view))], sizes))
    mem = r["memory"]
    assert mem["argument_bytes"] == want                          # exact
    assert mem["per_device_bytes"] == (mem["argument_bytes"]
                                       + mem["output_bytes"]
                                       + mem["temp_bytes"]
                                       - mem["alias_bytes"])
    if spec.kind == "train":     # donated: parameters and state come back
        assert mem["alias_bytes"] == want - _local_bytes(
            [tok, tok], [bp["tokens"], bp["labels"]], sizes)


_RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "trace_s",
                "hlo_flops", "hlo_bytes", "flop_counter_flops",
                "collective_bytes_per_device", "collectives", "memory",
                "roofline"}
_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "per_device_bytes", "hbm_fraction"}
_ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                  "step_time_lower_bound_s", "model_flops",
                  "model_flops_per_device", "useful_flops_ratio",
                  "roofline_fraction"}


def test_cli_writes_a_record_per_mesh_with_the_references_keys(runs):
    files = sorted(p.name for p in runs[2].glob("*.json"))
    assert files == ["baseline__llama3-8b__train_4k__multi.json",
                     "baseline__llama3-8b__train_4k__single.json"]
    for f in files:
        r = json.loads((runs[2] / f).read_text())
        assert r["ok"] and _RECORD_KEYS <= set(r)
        assert set(r["memory"]) == _MEMORY_KEYS
        assert set(r["roofline"]) == _ROOFLINE_KEYS


def test_importing_the_dry_run_touches_no_group_or_environment(runs):
    assert runs[1]["env_unchanged"] is True
    assert runs[1]["group_after_import"] is False


def test_cli_without_device_needs_cuda(monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "llama3-8b", "--shape", "train_4k"])


# ------------------------------------------------------------- B8's shape rule
def _b8(device, B=2, S=40, H=8, Kh=2, D=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, D, generator=g).to(dtype)
    k = torch.randn(B, S, Kh, D, generator=g).to(dtype)
    v = torch.randn(B, S, Kh, D, generator=g).to(dtype)
    lengths = torch.tensor([S, 7][:B], dtype=torch.int32)
    return [t.to(device) for t in (q, k, v, lengths)]


@pytest.mark.parametrize("kind", ["meta", "fake"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b8_shape_rule_on_meta_and_fake_inputs(kind, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = flash_decode.launches
    if kind == "meta":
        q, k, v, lengths = _b8("meta", dtype=dtype)
        cost, out = analyze_step(flash_decode, q, k, v, lengths)
    else:
        with FakeTensorMode() as mode:
            q, k, v, lengths = (mode.from_tensor(t) for t in _b8(
                "cpu", dtype=dtype))
            cost, out = analyze_step(flash_decode, q, k, v, lengths)
    assert tuple(out.shape) == (2, 8, 16) and out.dtype == dtype
    assert out.device == q.device
    assert flash_decode.launches == before
    # B8's own count, not the plain version's products
    assert cost["flops"] == 4 * 2 * 8 * 40 * 16
    assert cost["bytes_by_op"]["flash_decode"] == sum(
        t.numel() * t.element_size() for t in (q, k, v, lengths, out))


_BAD = {
    "rank": lambda q, k, v, l: (q[0], k, v, l),
    "v shape": lambda q, k, v, l: (q, k, v[:, :-1], l),
    "lengths": lambda q, k, v, l: (q, k, v, l[:1]),
    "dtype": lambda q, k, v, l: (q.half(), k.half(), v.half(), l),
    "mixed": lambda q, k, v, l: (q, k.bfloat16(), v, l),
    "lengths dtype": lambda q, k, v, l: (q, k, v, l.long()),
    "head dim": lambda q, k, v, l: (q[..., :8], k[..., :8], v[..., :8], l),
    "group": lambda q, k, v, l: (q[:, :7], k, v, l),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_b8_shape_rule_raises_the_kernels_errors(case):
    args = _BAD[case](*_b8("meta"))
    with pytest.raises(ValueError) as want:
        _check_shapes(*args)
    with pytest.raises(ValueError) as got:
        flash_decode(*args)
    assert str(got.value) == str(want.value)


def test_b8_cpu_tensors_still_run_the_plain_version():
    before = flash_decode.launches
    q, k, v, lengths = _b8("cpu")
    assert torch.equal(flash_decode(q, k, v, lengths),
                       flash_decode_plain(q, k, v, lengths))
    assert flash_decode.launches == before


# ------------------------------------------------------------------ report.py
def _records():
    recs = {}
    for i, (a, s, m) in enumerate(
            (a, s, m) for a in reversed(treport.ARCH_ORDER)
            for s in treport.SHAPE_ORDER for m in ("single", "multi")):
        if s == "long_500k" and i % 3:
            recs[a, s, m] = {"arch": a, "shape": s, "mesh": m, "ok": True,
                             "skipped": True}
            continue
        x = 1.7 ** (i % 13)
        recs[a, s, m] = {
            "arch": a, "shape": s, "mesh": m, "ok": True,
            "compile_s": 3.3 * x, "trace_s": 3.3 * x,
            "hlo_flops": 1.1e12 * x, "hlo_bytes": 2.3e10 * x,
            "collective_bytes_per_device": 4.5e9 / x,
            "collectives": {"all-gather": {"count": i, "bytes": 1.0},
                            "reduce-scatter": {"count": 2 * i,
                                               "bytes": 2.0}},
            "memory": {"per_device_bytes": 3.3e9 * x},
            "roofline": {"compute_s": 0.02 * x, "memory_s": 0.5 / x,
                         "collective_s": 150.0 / x ** 3,
                         "dominant": "memory_s",
                         "useful_flops_ratio": 0.97 / x,
                         "roofline_fraction": 0.3 / x}}
    return recs


def test_report_tables_are_the_references():
    recs = _records()
    for mesh in ("single", "multi"):
        assert treport.roofline_table(recs, mesh) == \
            jreport.roofline_table(recs, mesh)
    want = jreport.dryrun_table(recs).splitlines()
    got = treport.dryrun_table(recs).splitlines()
    assert got[0] == want[0].replace("compile_s", "trace_s")
    assert got[1:] == want[1:]
    assert treport.ARCH_ORDER == jreport.ARCH_ORDER
    assert treport.SHAPE_ORDER == jreport.SHAPE_ORDER


def test_report_loads_the_dry_runs_records(runs):
    recs = treport.load(runs[2], "baseline")
    assert set(recs) == {("llama3-8b", "train_4k", "single"),
                         ("llama3-8b", "train_4k", "multi")}
    table = treport.roofline_table(recs, "multi").splitlines()
    assert len(table) == 3 and table[2].startswith("| llama3-8b | train_4k")
    assert math.isfinite(recs["llama3-8b", "train_4k", "multi"][
        "roofline"]["useful_flops_ratio"])
