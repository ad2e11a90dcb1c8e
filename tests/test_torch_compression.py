"""The port's int8 error-feedback gradient compression against the JAX
package's, on the CPU.

- ``quantize`` / ``dequantize`` bit-equal to the reference under ``jit``
  (as ``make_compressed_dp_grad`` runs it; XLA computes ``amax / 127`` as
  a product by the f32 reciprocal, which op-by-op JAX does not) on
  seeded f32 and bf16 gradients, an all-zero gradient and a gradient of
  one large element.
- ``compressed_psum`` on four ``gloo`` ranks (one 4-rank mesh axis, and
  the two 2-rank ``data`` groups of a (2, 2) mesh) over three rounds of
  per-rank gradients, the residual carried from round to round: the mean
  and the new residual bit-equal to the reference's ``shard_map`` over 4
  and 2 forced host devices (a JAX subprocess). The int32 sums are exact
  and the scale is the group's max, so the order of the sum does not
  matter.
- The counterpart of ``tests/test_training.py::TestCompression::
  test_compressed_training_converges_subprocess``: the same config,
  optimizer and batch through ``make_compressed_dp_grad`` on 2 ``gloo``
  ranks for 30 steps, the last loss below 0.7 times the first.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax  # (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import compression as jc
from repro_torch.distributed import compression as tc

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
ROUNDS = 3
#: per-rank gradient leaves: (name, shape, dtype, scale, large element)
LEAVES = (("f32", (48, 20), "float32", 2.0, None),
          ("bf16", (33,), "bfloat16", 3.0, None),
          ("zero", (16,), "float32", 0.0, None),
          ("spike", (40,), "float32", 1e-3, 5e4))


def _grad(rng, shape, dtype, scale, spike):
    g = rng.normal(0, 1, shape) * scale
    if spike is not None:
        g.flat[int(rng.integers(g.size))] = spike
    return g.astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def _inputs(world: int = 4):
    """``{name: (grads (ROUNDS, world, ...), ef0 (world, ...) f32)}``."""
    rng = np.random.default_rng(11)
    out = {}
    for name, shape, dtype, scale, spike in LEAVES:
        grads = np.stack([np.stack([_grad(rng, shape, dtype, scale, spike)
                                    for _ in range(world)])
                          for _ in range(ROUNDS)])
        ef0 = (rng.normal(0, 1e-3, (world,) + shape).astype(np.float32)
               if scale else np.zeros((world,) + shape, np.float32))
        out[name] = (grads, ef0)
    return out


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


@pytest.mark.parametrize("name", [leaf[0] for leaf in LEAVES])
def test_quantize_dequantize_bit_equal(name):
    grads, _ = _inputs(1)[name]
    g = grads[0, 0]
    jq, js = jax.jit(jc.quantize)(jnp.asarray(g))
    tq, ts = tc.quantize(_to_torch(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts) == np.asarray(js).view(np.int32)
    jd = np.asarray(jax.jit(jc.dequantize)(jq, js))
    td = tc.dequantize(tq, ts)
    np.testing.assert_array_equal(_bits(td), jd.view(np.int32))


_JAX_PSUM = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.distributed.compression import compressed_psum

src, dst = sys.argv[1:3]
z = np.load(src)
names = sorted({k.split(":")[0] for k in z.files})
devs = jax.devices()
out = {}
for group, ranks in (("4", [0, 1, 2, 3]), ("2a", [0, 2]), ("2b", [1, 3])):
    mesh = Mesh(np.array([devs[i] for i in range(len(ranks))]), ("data",))

    def f(g, e):
        r, ne = compressed_psum(g[0], "data", e[0])
        return r[None], ne[None]

    fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_rep=False))
    for name in names:
        grads = z[name + ":grads"]
        if z[name + ":bf16"]:
            grads = grads.view(jnp.bfloat16)
        ef = jnp.asarray(z[name + ":ef0"][ranks])
        for r in range(grads.shape[0]):
            mean, ef = fn(jnp.asarray(grads[r][ranks]), ef)
            out[f"{group}/{name}/{r}/mean"] = np.asarray(mean)
            out[f"{group}/{name}/{r}/ef"] = np.asarray(ef)
np.savez(dst, **out)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep +
                os.environ.get("PYTHONPATH", ""))


def _run_group(world: int, argv, timeout: float = 300):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(world), port,
         *argv], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
def psum(tmp_path_factory):
    """(the reference's results, the port's per rank) of compressed_psum
    on every group."""
    tmp = tmp_path_factory.mktemp("psum")
    arrays = {}
    for name, (grads, ef0) in _inputs().items():
        bf16 = grads.dtype == ml_dtypes.bfloat16
        arrays[name + ":grads"] = grads.view(np.int16) if bf16 else grads
        arrays[name + ":bf16"] = np.array(bf16)
        arrays[name + ":ef0"] = ef0
    np.savez(tmp / "inputs.npz", **arrays)
    r = subprocess.run([sys.executable, "-c", _JAX_PSUM,
                        str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
                       capture_output=True, text=True, timeout=300,
                       env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    _run_group(4, ["psum", str(tmp)])
    ref = dict(np.load(tmp / "ref.npz"))
    port = [dict(np.load(tmp / f"port{r}.npz")) for r in range(4)]
    return ref, port


#: the port's groups: the 4-rank axis, and the (2, 2) mesh's data groups
GROUPS = {"4": [0, 1, 2, 3], "2a": [0, 2], "2b": [1, 3]}


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("name", [leaf[0] for leaf in LEAVES])
def test_compressed_psum_bit_equal_to_shard_map(psum, group, name):
    ref, port = psum
    for r in range(ROUNDS):
        for i, rank in enumerate(GROUPS[group]):
            for what in ("mean", "ef"):
                want = ref[f"{group}/{name}/{r}/{what}"][i]
                got = port[rank][f"{group}/{name}/{r}/{what}"]
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(
                    got.view(np.int32), want.view(np.int32),
                    err_msg=f"round {r} rank {rank} {what}")


def test_compressed_training_converges_on_two_ranks(tmp_path):
    _run_group(2, ["converge", str(tmp_path)])
    got = json.loads((tmp_path / "converge.json").read_text())
    assert got["ranks_agree"], got
    assert got["last"] < 0.7 * got["first"], got
    assert got["payload_dtypes"] == ["torch.int32"], got


def test_compressed_psum_needs_its_mesh():
    with pytest.raises(RuntimeError, match="collective_mesh"):
        tc.compressed_psum(torch.zeros(3), "data", torch.zeros(3))
    with pytest.raises(TypeError):
        tc.make_compressed_dp_grad(lambda p, b: 0, object())


def test_ef_init_is_zeros_of_f32():
    params = {"w": torch.ones((3, 2), dtype=torch.bfloat16),
              "b": [torch.ones(4)]}
    ef = tc.ef_init(params)
    assert ef["w"].dtype == ef["b"][0].dtype == torch.float32
    assert ef["w"].shape == (3, 2) and not ef["w"].any()


# ------------------------------------------------------------- the worker
def _psum_worker(rank: int, tmp: Path):
    from torch.distributed.device_mesh import DeviceMesh
    flat = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
    square = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    inputs = _inputs()
    out = {}
    for group, mesh in (("4", flat), ("2", square)):
        label = group if group == "4" else ("2a" if rank in (0, 2) else "2b")
        with tc.collective_mesh(mesh):
            for name, (grads, ef0) in inputs.items():
                ef = _to_torch(ef0[rank])
                for r in range(ROUNDS):
                    mean, ef = tc.compressed_psum(_to_torch(grads[r, rank]),
                                                  "data", ef)
                    out[f"{label}/{name}/{r}/mean"] = mean.numpy()
                    out[f"{label}/{name}/{r}/ef"] = ef.numpy()
    np.savez(tmp / f"port{rank}.npz", **out)


def _converge_worker(rank: int, tmp: Path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs.paper_stream import consumer_lm
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import (AdamW, adamw_init,
                                                adamw_update)
    cfg = consumer_lm().replace(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, head_dim=16, d_ff=128,
                                vocab_size=512, loss_chunk=16)
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
    params = T.init_params(cfg, 0, device="cpu")
    ef = tc.ef_init(params)
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=40)
    opt_state = adamw_init(params)
    grad_fn = tc.make_compressed_dp_grad(
        lambda p, b: T.loss_fn(cfg, p, b)[0], mesh, "data")
    rng = np.random.default_rng(0)
    chunk = rng.integers(1, 512, (4, 33), dtype=np.int32)
    batch = {"inputs": torch.from_numpy(chunk[:, :-1].copy()),
             "labels": torch.from_numpy(chunk[:, 1:].copy())}
    seen = set()
    real = dist.all_reduce

    def spy(t, *a, **kw):          # the dtype of every payload summed
        if kw.get("op", a[0] if a else None) == dist.ReduceOp.SUM and \
                t.numel() > 1:
            seen.add(str(t.dtype))
        return real(t, *a, **kw)

    dist.all_reduce = spy
    try:
        losses = []
        for _ in range(30):
            loss, grads, ef = grad_fn(params, batch, ef)
            params, opt_state, _ = adamw_update(opt, grads, opt_state,
                                                params)
            losses.append(float(loss))
    finally:
        dist.all_reduce = real
    every = [None, None]
    dist.all_gather_object(every, losses)
    if rank == 0:
        (tmp / "converge.json").write_text(json.dumps({
            "first": losses[0], "last": losses[-1],
            "ranks_agree": every[0] == every[1],
            "payload_dtypes": sorted(seen)}))


def _worker(rank: int, world: int, port: int, task: str, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        {"psum": _psum_worker, "converge": _converge_worker}[task](
            rank, Path(tmp))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        r, w, p, task, d = sys.argv[2:7]
        _worker(int(r), int(w), int(p), task, d)
