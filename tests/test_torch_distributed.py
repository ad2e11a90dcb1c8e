"""The port's distribution layer against the JAX package, on the CPU.

- Spec tables: ``param_pspecs`` (both policies), ``cache_pspecs``
  (``decode_32k`` and, where supported, ``long_500k``; ``shard_seq`` on
  and off), ``batch_pspec`` and ``activation_rules`` of the ten published
  configs at the production meshes (16, 16) and (2, 16, 16) and at
  (2, 2), (4, 1) and (1, 4), held path by path to the reference's. Both
  packages' tables read only the mesh's axis sizes and names, so a
  namespace stands in for the mesh and no device is touched.
- Shapes: ``param_specs`` and ``input_specs`` (all 40 cells) equal to the
  reference's ``ShapeDtypeStruct``s.
- Layouts: on four ``gloo`` ranks each rank's local shard equals the
  numpy slice that ``NamedSharding.devices_indices_map`` gives the JAX
  device of the same index (a JAX subprocess with four forced host
  devices), at (2, 2), (4, 1), (1, 4) and (1, 2, 2).
- The sharded steps and the sharded checkpoint, on one group of four
  ``gloo`` ranks spawned once (``python tests/test_torch_distributed.py
  --worker``); rank 0 compares with the unsharded port and writes its
  findings, which the tests read:
  - at DP 1 (mesh (1, 4)) two train steps under ``tp`` and ``fsdp_tp``
    are bit-equal to the unsharded step: loss, metrics, gradients,
    parameters and moments;
  - with DP 2 and 4 ((2, 2), (4, 1)) the loss and every gradient leaf
    within 1e-5 of the unsharded step's, relative to the leaf's largest
    |g| (the DP ranks' gradients are averaged, a sum in another order).
    After two steps, moments within 1e-4 of the leaf's largest magnitude
    and parameters within ``4 * lr``: AdamW's first update is about
    ``lr * sign(g)``, so an element whose gradient is near zero can move
    ``2 * lr`` the other way under another summation order; at most 1 %
    of a leaf's elements may differ by more than 1e-5;
  - every output leaf in the spec tables' layout; metrics the same on
    every rank;
  - the prefill step and four serve steps (llama3-8b and
    recurrentgemma-2b smoke, B 4, ``shard_seq`` on, mesh (2, 2)) equal
    to the unsharded steps within 1e-5 (logits and the gathered cache),
    and B 1 on a DP of 2 (the cache's batch axis replicated);
  - a checkpoint saved from (2, 2) restored with ``shardings`` onto (2, 2)
    and (4, 1) bit for bit, each leaf in the layout asked for.
"""

import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.configs import get_smoke, input_specs
from repro_torch.distributed import sharding as tsh
from repro_torch.models import transformer as T

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")

#: the meshes of the tables, by shape: the production ones first
TABLE_MESHES = {(16, 16): ("data", "model"),
                (2, 16, 16): ("pod", "data", "model"),
                (2, 2): ("data", "model"), (4, 1): ("data", "model"),
                (1, 4): ("data", "model")}
LAYOUT_MESHES = {(2, 2): ("data", "model"), (4, 1): ("data", "model"),
                 (1, 4): ("data", "model"),
                 (1, 2, 2): ("pod", "data", "model")}
LAYOUT_ARCHS = ("llama3-8b", "deepseek-v3-671b", "recurrentgemma-2b")
LAYOUT_CACHE = (4, 8)                      # (batch, max_len)
TRAIN_ARCHS = ("llama3-8b", "deepseek-v3-671b", "recurrentgemma-2b",
               "rwkv6-1_6b")
TRAIN_MESHES = ((1, 4), (2, 2), (4, 1))
SERVE_ARCHS = ("llama3-8b", "recurrentgemma-2b")
LR = 1e-3
GRAD_RTOL = 1e-5
MOMENT_RTOL = 1e-4
PARAM_ATOL = 4 * LR
SERVE_TOL = 1e-5


def _ns_mesh(shape, names):
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def _mesh_key(shape) -> str:
    return "x".join(map(str, shape))


# ------------------------------------------------------------ spec tables
def _ref_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _ref_specs(tree_):
    import jax
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree_, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_ref_key(p): tuple(s) for p, s in flat}


def _port_specs(tree_):
    out = {}

    def walk(t, prefix):
        if isinstance(t, tsh.P):
            out[tree.path_key(prefix)] = tuple(t)
        elif isinstance(t, dict):
            for k in sorted(t):                 # the leaves' order
                walk(t[k], prefix + (k,))
        else:
            for i, v in enumerate(t):
                walk(v, prefix + (i,))
    walk(tree_, ())
    return out


_REF_PARAMS = {}


def _ref_param_shapes(arch):
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = JT.param_specs(jget(arch))
    return _REF_PARAMS[arch]


@pytest.mark.parametrize("mesh", list(TABLE_MESHES), ids=_mesh_key)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_are_the_references(arch, mesh):
    from repro.configs import get_config as jget
    from repro.distributed import sharding as jsh
    names = TABLE_MESHES[mesh]
    m = _ns_mesh(mesh, names)
    ref_shapes, port_shapes = _ref_param_shapes(arch), T.param_specs(
        get_config(arch))
    for policy in ("tp", "fsdp_tp"):
        want = _ref_specs(jsh.param_pspecs(jget(arch), m, ref_shapes, policy))
        got = _port_specs(tsh.param_pspecs(get_config(arch), m, port_shapes,
                                           policy))
        assert got == want, policy


@pytest.mark.parametrize("mesh", list(TABLE_MESHES), ids=_mesh_key)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_are_the_references(arch, mesh):
    from repro.configs import get_config as jget
    from repro.configs import input_specs as jinput_specs
    from repro.distributed import sharding as jsh
    m = _ns_mesh(mesh, TABLE_MESHES[mesh])
    cells = [s for s in ("decode_32k", "long_500k")
             if cell_supported(get_config(arch), s)]
    for shape in cells:
        ref_cache = jinput_specs(jget(arch), shape)["cache"]
        port_cache = input_specs(get_config(arch), shape)["cache"]
        for shard_seq in (True, False):
            want = _ref_specs(jsh.cache_pspecs(jget(arch), m, ref_cache,
                                               shard_seq=shard_seq))
            got = _port_specs(tsh.cache_pspecs(get_config(arch), m,
                                               port_cache,
                                               shard_seq=shard_seq))
            assert got == want, (shape, shard_seq)


@pytest.mark.parametrize("mesh", list(TABLE_MESHES), ids=_mesh_key)
def test_batch_pspec_and_activation_rules_are_the_references(mesh):
    from repro.distributed import sharding as jsh
    m = _ns_mesh(mesh, TABLE_MESHES[mesh])
    got, want = tsh.batch_pspec(m), jsh.batch_pspec(m)
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    for shard_seq in (True, False):
        assert tsh.activation_rules(m, shard_seq=shard_seq) == \
            jsh.activation_rules(m, shard_seq=shard_seq)
    assert tsh.RULESETS == jsh.RULESETS
    assert tsh.DP_AXES == jsh.DP_AXES


def test_spec_type_equals_partition_spec():
    from jax.sharding import PartitionSpec
    for entries in [(("data",), None), (("pod", "data"), "model"), ((),),
                    ("model", None, None), ()]:
        p, j = tsh.P(*entries), PartitionSpec(*entries)
        assert tuple(p) == tuple(j) and j == tuple(p)


def test_a_mesh_must_be_mesh_shaped():
    with pytest.raises(TypeError):
        tsh.batch_pspec(object())
    with pytest.raises(TypeError):
        tsh.param_pspecs(get_smoke("llama3-8b"), (2, 2),
                         T.param_specs(get_smoke("llama3-8b")))


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _shapes(flat):
    return {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(arch):
    import jax
    ref = _shapes((_ref_key(p), v) for p, v in
                  jax.tree_util.tree_flatten_with_path(
                      _ref_param_shapes(arch))[0])
    port_tree = T.param_specs(get_config(arch))
    assert all(t.device.type == "meta" for t in tree.leaves(port_tree))
    got = _shapes((tree.path_key(p), v)
                  for p, v in tree.leaves_with_path(port_tree))
    assert got == ref


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(arch, shape):
    import jax
    from repro.configs import get_config as jget
    from repro.configs import input_specs as jinput_specs
    ref = _shapes((_ref_key(p), v) for p, v in
                  jax.tree_util.tree_flatten_with_path(
                      jinput_specs(jget(arch), shape))[0])
    port_tree = input_specs(get_config(arch), shape)
    assert all(t.device.type == "meta" for t in tree.leaves(port_tree))
    got = _shapes((tree.path_key(p), v)
                  for p, v in tree.leaves_with_path(port_tree))
    assert got == ref


# ------------------------------------------------------------- meshes
def test_meshes_need_a_group_and_cuda():
    from repro_torch.launch import mesh as tmesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.make_host_mesh(1, 1)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh()


def test_sharded_steps_refuse_what_is_not_a_mesh_and_cuda_without_cuda():
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as tmesh
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.steps import (jit_prefill_step,
                                            jit_serve_step, jit_train_step)
    cfg = get_smoke("llama3-8b")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        assert tmesh.make_host_mesh(1, 1, device="cpu").mesh_dim_names == (
            "data", "model")
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_host_mesh(2, 1, device="cpu")
        with pytest.raises(RuntimeError, match="256"):
            tmesh.make_production_mesh()
        for bad in (object(), _ns_mesh((1, 1), ("data", "model"))):
            for make in (lambda m: jit_train_step(cfg, AdamW(), mesh=m),
                         lambda m: jit_serve_step(cfg, mesh=m),
                         lambda m: jit_prefill_step(cfg, mesh=m)):
                with pytest.raises(TypeError):
                    make(bad)
        if not torch.cuda.is_available():
            cuda = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                              mesh_dim_names=("data", "model"))
            with pytest.raises(RuntimeError, match="cuda"):
                jit_train_step(cfg, AdamW(), mesh=cuda)
            with pytest.raises(RuntimeError, match="cuda"):
                jit_serve_step(cfg, mesh=cuda, batch=1, max_len=8)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the gloo group
_JAX_LAYOUTS = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import get_smoke
from repro.distributed.sharding import cache_pspecs, param_pspecs
from repro.models import transformer as T

meshes, archs, (b, s) = json.loads(sys.argv[1])


def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


out = {}
for shape, names in meshes:
    mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(names))
    mk = "x".join(map(str, shape))
    for arch in archs:
        cfg = get_smoke(arch)
        pshape = T.param_specs(cfg)
        cshape = jax.eval_shape(lambda: T.init_cache(cfg, b, s))
        for kind, shapes, specs in (
                ("params", pshape, param_pspecs(cfg, mesh, pshape,
                                                "fsdp_tp")),
                ("cache", cshape, cache_pspecs(cfg, mesh, cshape,
                                               shard_seq=True))):
            flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
            sflat = jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
            for (path, leaf), spec in zip(flat, sflat):
                idx = NamedSharding(mesh, spec).devices_indices_map(
                    leaf.shape)
                out[f"{mk}/{arch}/{kind}/{key(path)}"] = {
                    str(d.id): [[sl.start or 0, n if sl.stop is None
                                 else sl.stop]
                                for sl, n in zip(ix, leaf.shape)]
                    for d, ix in idx.items()}
json.dump(out, sys.stdout)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(world: int, argv, timeout: float = 600):
    """``world`` processes of this file's ``--worker`` in one gloo group;
    each returns 0 or the test fails with its output."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(world), port,
         *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One JAX subprocess for the layouts, then one group of four gloo
    ranks running every distributed check; rank 0's findings."""
    tmp = tmp_path_factory.mktemp("dist")
    meshes = [[list(s), list(n)] for s, n in LAYOUT_MESHES.items()]
    r = subprocess.run(
        [sys.executable, "-c", _JAX_LAYOUTS,
         json.dumps([meshes, list(LAYOUT_ARCHS), list(LAYOUT_CACHE)])],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC + os.pathsep +
                 os.environ.get("PYTHONPATH", "")))
    assert r.returncode == 0, r.stderr[-4000:]
    (tmp / "jax_layouts.json").write_text(r.stdout)
    _run_group(4, [str(tmp)])
    return json.loads((tmp / "findings.json").read_text())


@pytest.mark.parametrize("mesh", list(LAYOUT_MESHES), ids=_mesh_key)
def test_local_shards_are_the_references_slices(group, mesh):
    found = group["layouts"][_mesh_key(mesh)]
    leaves = sum(len(tree.leaves(T.param_specs(get_smoke(a)))) + len(
        tree.leaves(T.init_cache(get_smoke(a), *LAYOUT_CACHE,
                                 device="meta"))) for a in LAYOUT_ARCHS)
    assert found["compared"] == leaves, found
    assert found["mismatched"] == [], found["mismatched"][:5]
    assert found["missing"] == [], found["missing"][:5]
    assert found["own_slice_differs"] == []


def test_constrain(group):
    assert group["constrain"] == {
        "identity_outside": True, "placements": True, "values": True,
        "local_unchanged": True, "rank_mismatch_unchanged": True}


def _train(group, arch, mesh, policy):
    return group["train"][f"{arch}/{_mesh_key(mesh)}/{policy}"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_at_dp1_is_bit_exact(group, arch):
    for policy in ("tp", "fsdp_tp"):
        f = _train(group, arch, (1, 4), policy)
        assert f["metrics_equal"] and f["grads_equal"], (policy, f)
        assert f["params_equal"] and f["moments_equal"], (policy, f)
        assert f["layouts"] and f["metrics_replicated"], (policy, f)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=_mesh_key)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_with_dp_is_within_tolerance(group, arch, mesh):
    for policy in ("tp", "fsdp_tp"):
        f = _train(group, arch, mesh, policy)
        assert f["loss_rel_err"] <= GRAD_RTOL, (policy, f)
        assert f["grad_rel_err"] <= GRAD_RTOL, (policy, f)
        assert f["moment_rel_err"] <= MOMENT_RTOL, (policy, f)
        assert f["param_abs_err"] <= PARAM_ATOL, (policy, f)
        assert f["param_frac_over_1e-5"] <= 0.01, (policy, f)
        assert f["layouts"] and f["metrics_replicated"], (policy, f)


def test_donated_train_step_updates_its_dtensors_in_place(group):
    assert group["donate"] == {"same_objects": True, "equal": True}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_serve_steps_match_unsharded(group, arch):
    f = group["serve"][f"{arch}/B4"]
    assert f["prefill_logits_err"] <= SERVE_TOL, f
    assert f["prefill_cache_err"] <= SERVE_TOL, f
    assert f["prefill_layouts"] and f["serve_layouts"], f
    assert len(f["logits_err"]) == 4, f
    assert max(f["logits_err"]) <= SERVE_TOL, f
    assert f["cache_err"] <= SERVE_TOL, f
    assert f["batch_sharded"], f


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_step_with_one_sequence_on_two_dp_ranks(group, arch):
    f = group["serve"][f"{arch}/B1"]
    assert not f["batch_sharded"], f
    assert f["serve_layouts"], f
    assert max(f["logits_err"]) <= SERVE_TOL, f
    assert f["cache_err"] <= SERVE_TOL, f


@pytest.mark.parametrize("target", [(2, 2), (4, 1)], ids=_mesh_key)
def test_sharded_checkpoint_restores_bit_for_bit(group, target):
    f = group["checkpoint"][_mesh_key(target)]
    assert f == {"bit_equal": True, "placements": True, "leaves": f["leaves"],
                 "manifest_as_unsharded": True}
    assert f["leaves"] > 10


# ------------------------------------------------------------- the worker
def _seeded_batches(cfg, n, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(1, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        out.append({"inputs": torch.from_numpy(toks[:, :-1].copy()),
                    "labels": torch.from_numpy(toks[:, 1:].copy())})
    return out


def _rel(a, b) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(scale, 1e-30) if b.numel() \
        else 0.0


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _mesh(shape, names=None):
    from torch.distributed.device_mesh import DeviceMesh
    names = names or (("data", "model") if len(shape) == 2 else
                      ("pod", "data", "model"))
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def _check_layouts(rank, tmp: Path):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import layout
    maps = json.loads((tmp / "jax_layouts.json").read_text())
    found = {}
    for shape, names in LAYOUT_MESHES.items():
        mesh = _mesh(shape, names)
        mk = _mesh_key(shape)
        rec = {"compared": 0, "mismatched": [], "missing": [],
               "own_slice_differs": []}
        for arch in LAYOUT_ARCHS:
            cfg = get_smoke(arch)
            pshape = T.param_specs(cfg)
            cshape = T.init_cache(cfg, *LAYOUT_CACHE, device="meta")
            for kind, shapes, specs in (
                    ("params", pshape, tsh.param_pspecs(cfg, mesh, pshape,
                                                        "fsdp_tp")),
                    ("cache", cshape, tsh.cache_pspecs(cfg, mesh, cshape,
                                                       shard_seq=True))):
                flat = tree.leaves_with_path(shapes)
                sflat = list(_port_specs(specs).values())
                for (path, leaf), spec in zip(flat, sflat):
                    k = f"{mk}/{arch}/{kind}/{tree.path_key(path)}"
                    if k not in maps:
                        rec["missing"].append(k)
                        continue
                    n = math.prod(leaf.shape)
                    whole = torch.arange(n, dtype=torch.float32).reshape(
                        tuple(leaf.shape))
                    pl = tsh.NamedSharding(mesh, tsh.P(*spec)).placements
                    mine = distribute_tensor(whole, mesh, pl,
                                             src_data_rank=None).to_local()
                    want = whole[tuple(slice(a, b) for a, b in
                                       maps[k][str(rank)])]
                    rec["compared"] += 1
                    if not torch.equal(mine, want):
                        rec["mismatched"].append(k)
                    if not torch.equal(layout.own_slice(whole, mesh, pl),
                                       mine):
                        rec["own_slice_differs"].append(k)
        found[mk] = rec
    return found


def _check_constrain():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.api import constrain, sharding_rules
    mesh = _mesh((2, 2))
    whole = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    x = distribute_tensor(whole, mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    out = {"identity_outside": constrain(x, "batch", "seq", "embed") is x}
    with sharding_rules(mesh, tsh.activation_rules(mesh, shard_seq=True)):
        y = constrain(x, "batch", "seq", "embed")
        out["placements"] = tuple(y.placements) == (Shard(0), Shard(1))
        out["values"] = torch.equal(y.full_tensor(), whole)
        out["local_unchanged"] = constrain(whole, "batch", "seq",
                                           "embed") is whole
        out["rank_mismatch_unchanged"] = constrain(x, "batch", "seq") is x
    return out


def _placements_ok(got, specs, mesh) -> bool:
    want = [tsh.NamedSharding(mesh, tsh.P(*s)).placements
            for s in _port_specs(specs).values()]
    have = [tuple(t.placements) for t in tree.leaves(got)]
    return have == want


def _replicated(metrics) -> bool:
    import torch.distributed as dist
    mine = {k: float(v) for k, v in metrics.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return all(e == mine for e in every)


def _check_train(rank):
    from repro_torch.training import steps
    from repro_torch.training.optimizer import AdamW, adamw_init
    opt = AdamW(lr=LR, warmup_steps=1)
    found, donate = {}, {}
    for arch in TRAIN_ARCHS:
        cfg = get_smoke(arch)
        params = T.init_params(cfg, 0, device="cpu")
        batches = _seeded_batches(cfg, 2)
        if rank == 0:                  # the unsharded step, compared here
            (rl, rm), rg = steps.value_and_grad(cfg, params, batches[0])
            rp, rs = tree.tree_map(torch.clone, params), adamw_init(params)
            for b in batches:
                rp, rs, rmet = steps.make_train_step(cfg, opt)(rp, rs, b)
        for shape in TRAIN_MESHES:
            mesh = _mesh(shape)
            for policy in ("tp", "fsdp_tp"):
                pspec = tsh.param_pspecs(cfg, mesh, T.param_specs(cfg),
                                         policy)
                (loss, met), g, _ = steps.sharded_value_and_grad(
                    cfg, mesh, policy)(params, batches[0])
                g_whole = [_whole(t) for t in tree.leaves(g)]
                step = steps.jit_train_step(cfg, opt, mesh, policy,
                                            donate=False)
                sp, ss = params, adamw_init(params)
                for b in batches:
                    sp, ss, smet = step(sp, ss, b)
                p_whole = [_whole(t) for t in tree.leaves(sp)]
                m_whole = [_whole(t) for t in tree.leaves(ss["m"])]
                v_whole = [_whole(t) for t in tree.leaves(ss["v"])]
                layouts = (_placements_ok(g, pspec, mesh)
                           and _placements_ok(sp, pspec, mesh)
                           and _placements_ok(ss["m"], pspec, mesh)
                           and _placements_ok(ss["v"], pspec, mesh)
                           and all(p.is_replicate()
                                   for p in ss["step"].placements))
                replicated = _replicated(smet)
                if rank:
                    continue
                ref_p, ref_m, ref_v = (tree.leaves(rp), tree.leaves(rs["m"]),
                                       tree.leaves(rs["v"]))
                diffs = [(a - b).abs() for a, b in zip(p_whole, ref_p)]
                found[f"{arch}/{_mesh_key(shape)}/{policy}"] = {
                    "metrics_equal": all(
                        torch.equal(smet[k], rmet[k]) for k in rmet)
                    and torch.equal(loss, rl) and all(
                        torch.equal(met[k], rm[k]) for k in rm),
                    "grads_equal": all(torch.equal(a, b) for a, b in
                                       zip(g_whole, tree.leaves(rg))),
                    "params_equal": all(torch.equal(a, b) for a, b in
                                        zip(p_whole, ref_p)),
                    "moments_equal": all(
                        torch.equal(a, b) for a, b in
                        zip(m_whole + v_whole, ref_m + ref_v)),
                    "loss_rel_err": _rel(loss, rl),
                    "grad_rel_err": max(_rel(a, b) for a, b in
                                        zip(g_whole, tree.leaves(rg))),
                    "moment_rel_err": max(_rel(a, b) for a, b in
                                          zip(m_whole + v_whole,
                                              ref_m + ref_v)),
                    "param_abs_err": max(float(d.max()) for d in diffs),
                    "param_frac_over_1e-5": max(
                        float((d > 1e-5).float().mean()) for d in diffs),
                    "layouts": layouts, "metrics_replicated": replicated,
                }
        if arch == "llama3-8b":        # donation: the same DTensors back
            mesh = _mesh((2, 2))
            step = steps.jit_train_step(cfg, opt, mesh, "fsdp_tp")
            sp, ss = steps.jit_train_step(cfg, opt, mesh, "fsdp_tp",
                                          donate=False)(
                params, adamw_init(params), batches[0])[:2]
            want = steps.jit_train_step(cfg, opt, mesh, "fsdp_tp",
                                        donate=False)(sp, ss, batches[1])[0]
            got_p, got_s, _ = step(sp, ss, batches[1])
            donate = {"same_objects": got_p is sp and got_s is ss and all(
                a is b for a, b in zip(tree.leaves(got_p), tree.leaves(sp))),
                "equal": all(torch.equal(_whole(a), _whole(b)) for a, b in
                             zip(tree.leaves(got_p), tree.leaves(want)))}
    return found, donate


def _grow(cache, cfg, max_len):
    """An unsharded prefill cache grown to ``max_len`` positions (a
    ``local`` ring to ``min(max_len, window)``), the prompt's rows first."""
    out = T.init_cache(cfg, cache["pos"].shape[0], max_len, device="cpu")
    for run, src in zip(out["runs"], cache["runs"]):
        for k, t in run.items():
            s = src[k]
            if k in ("k", "v", "ckv", "kr"):
                t[:, :, :s.shape[2]] = s[:, :, :t.shape[2]]
            else:
                t.copy_(s)
    out["pos"].copy_(cache["pos"])
    return out


def _check_serve(rank):
    from repro_torch.training import steps
    found = {}
    mesh = _mesh((2, 2))
    for arch in SERVE_ARCHS:
        cfg = get_smoke(arch)
        params = T.init_params(cfg, 1, device="cpu")
        for b in (4, 1):
            rng = np.random.default_rng(b)
            p_len, max_len = 8, 16
            toks = torch.from_numpy(rng.integers(
                1, cfg.vocab_size, (b, p_len)).astype(np.int32))
            lens = torch.from_numpy(rng.integers(
                1, p_len + 1, b).astype(np.int32))
            nxt = [torch.from_numpy(rng.integers(
                1, cfg.vocab_size, b).astype(np.int32)) for _ in range(4)]
            ref_logits, ref_cache = steps.make_forward_step(cfg)(
                params, toks, lens)
            rec = {}
            if b % 2 == 0:
                logits, cache = steps.jit_prefill_step(cfg, mesh)(
                    params, toks, lens)
                rec["prefill_logits_err"] = float(
                    (logits.full_tensor() - ref_logits).abs().max())
                rec["prefill_cache_err"] = max(
                    float((a.full_tensor() - c).abs().max()) for a, c in
                    zip(tree.leaves(cache), tree.leaves(ref_cache)))
                cspec = tsh.cache_pspecs(cfg, mesh, ref_cache)
                rec["prefill_layouts"] = _placements_ok(cache, cspec, mesh)
            grown = _grow(ref_cache, cfg, max_len)
            ref = tree.tree_map(torch.clone, grown)
            serve = steps.jit_serve_step(cfg, mesh, batch=b,
                                         max_len=max_len)
            cache, errs = grown, []
            for t in nxt:
                got, cache = serve(params, cache, t)
                got = got.full_tensor()
                if rank == 0:          # the unsharded step, compared here
                    want, ref = steps.jit_serve_step(cfg)(params, ref, t)
                    errs.append(float((got - want).abs().max()))
            whole = [a.full_tensor() for a in tree.leaves(cache)]
            rec["logits_err"] = errs
            rec["cache_err"] = max(
                float((a - c).abs().max()) for a, c in
                zip(whole, tree.leaves(ref)))
            cspec = tsh.cache_pspecs(cfg, mesh, T.init_cache(
                cfg, b, max_len, device="meta"))
            rec["serve_layouts"] = _placements_ok(cache, cspec, mesh)
            rec["batch_sharded"] = any(
                p.is_shard() for p in cache["pos"].placements)
            found[f"{arch}/B{b}"] = rec
    return found


def _check_checkpoint(rank, tmp: Path):
    import torch.distributed as dist

    from repro_torch.training import steps
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import AdamW, adamw_init
    cfg = get_smoke("llama3-8b")
    params = T.init_params(cfg, 2, device="cpu")
    src = _mesh((2, 2))
    sp, ss, _ = steps.jit_train_step(cfg, AdamW(lr=LR, warmup_steps=1), src,
                                     "fsdp_tp", donate=False)(
        params, adamw_init(params), _seeded_batches(cfg, 1)[0])
    state = {"params": sp, "opt": ss}
    whole = [_whole(t) for t in tree.leaves(state)]
    mgr = CheckpointManager(tmp / "ckpt")
    mgr.save(1, state)
    if rank == 0:
        plain = CheckpointManager(tmp / "ckpt_plain")
        plain.save(1, tree.unflatten(state, whole))
        same = plain.manifest(1)["leaves"] == mgr.manifest(1)["leaves"]
    dist.barrier()
    like = {"params": params, "opt": adamw_init(params)}
    found = {}
    for shape in ((2, 2), (4, 1)):
        mesh = _mesh(shape)
        pspec = tsh.param_pspecs(cfg, mesh, T.param_specs(cfg), "fsdp_tp")
        specs = {"params": pspec,
                 "opt": {"step": tsh.P(), "m": pspec, "v": pspec}}
        shardings = tsh.named(mesh, specs)
        got = mgr.restore(like, 1, shardings)
        back = [_whole(t) for t in tree.leaves(got)]
        if rank == 0:
            found[_mesh_key(shape)] = {
                "bit_equal": all(torch.equal(a, b) and a.dtype == b.dtype
                                 for a, b in zip(back, whole)),
                "placements": _placements_ok(got, specs, mesh),
                "leaves": len(back), "manifest_as_unsharded": same}
    return found


def _worker(rank: int, world: int, port: int, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    tmp = Path(tmp)
    findings = {"layouts": _check_layouts(rank, tmp),
                "constrain": _check_constrain()}
    findings["train"], findings["donate"] = _check_train(rank)
    findings["serve"] = _check_serve(rank)
    findings["checkpoint"] = _check_checkpoint(rank, tmp)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        (tmp / "findings.json").write_text(json.dumps(findings))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        r, w, p, d = sys.argv[2:6]
        _worker(int(r), int(w), int(p), d)
