"""The port stands alone: no module of ``src/repro_torch``, no script
under ``tools/`` and no line of ``chip_smoke.py`` imports JAX or the JAX
package, the port imports and runs with both blocked, and nothing runs on
the CPU unless asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + sorted((REPO / "tools").glob(
        "*.py")) + sorted((REPO / "examples").glob("torch_*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    yield arg.value


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_has_the_slice_modules():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for mod in ("kernels/_build.py", "kernels/stream_sample.py",
                "kernels/compact.py", "kernels/metrics_fused.py",
                "kernels/trend_scan.py", "kernels/ops.py",
                "streamsim/engine.py", "streamsim/controller.py",
                "streamsim/producer.py", "streamsim/queue.py",
                "streamsim/resilience.py", "streamsim/nsa.py",
                "streamsim/store.py", "streamsim/plan.py",
                "core/__init__.py", "kernels/flash_decode.py",
                "models/config.py", "models/layers.py",
                "models/attention.py", "models/transformer.py",
                "configs/__init__.py", "configs/llama3_8b.py",
                "configs/paper_stream.py", "training/data.py",
                "serving/engine.py", "serving/load.py",
                "streamsim/tasks.py", "launch/serve.py",
                "streamsim/service.py", "distributed/api.py",
                "distributed/__init__.py", "streamsim/taskbench.py",
                "kernels/tuning.py", "tree.py", "training/optimizer.py",
                "training/steps.py", "training/checkpoint.py",
                "training/ft.py", "training/train_loop.py",
                "launch/train.py", "models/rglru.py", "models/rwkv6.py",
                "models/moe.py", "distributed/sharding.py",
                "distributed/compression.py", "distributed/layout.py",
                "launch/mesh.py", "launch/dryrun.py",
                "launch/hlo_analysis.py", "launch/report.py"):
        assert mod in names
    import importlib
    for mod, attr in (("kernels.metrics_fused", "stream_metrics_carry"),
                      ("kernels.trend_scan", "trend_scan_carry"),
                      ("kernels.ops", "stream_metrics_chunk"),
                      ("kernels.ops", "trend_scan_chunk"),
                      ("streamsim.nsa", "ChunkedNSA"),
                      ("streamsim.producer", "ChunkFeed"),
                      ("streamsim.engine", "ChunkedSweepRunner"),
                      ("kernels.ops", "flash_decode"),
                      ("streamsim", "ServingTask"),
                      ("models.transformer", "params_from_numpy"),
                      ("streamsim", "SweepService"),
                      ("streamsim", "nsa_sweep"),
                      ("kernels.ops", "compact_mask"),
                      ("distributed", "process_topology"),
                      ("kernels.tuning", "KernelTuner"),
                      ("models.transformer", "loss_fn"),
                      ("models.transformer", "opt_state_from_numpy"),
                      ("training", "TrainLoop"),
                      ("distributed", "param_pspecs"),
                      ("distributed.compression", "compressed_psum"),
                      ("launch.mesh", "make_host_mesh"),
                      ("configs", "input_specs"),
                      ("models.transformer", "param_specs"),
                      ("training.steps", "sharded_value_and_grad")):
        assert hasattr(importlib.import_module(f"repro_torch.{mod}"), attr)
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "stream_sample.cu", "compact.cu", "metrics_fused.cu",
        "trend_scan.cu", "pair_stats.cu", "flash_decode.cu"}


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys, tempfile
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.streamsim import Controller
with tempfile.TemporaryDirectory() as d:
    rep = Controller(d, device="cpu").run(
        "traffic", 40, lambda q: {"n": sum(len(b) for b in q)},
        scale=0.002, seed=9, backend="torch")
assert rep.consumer_metrics["n"] == rep.simulated_rows > 0
with tempfile.TemporaryDirectory() as d:
    ctl = Controller(d, device="cpu")
    reps = ctl.run_many(
        ["traffic", "sogouq"], [20, 40], lambda q: {"n": sum(len(b) for b in q)},
        scale=0.002, seed=9, backend="torch")
assert ctl.last_result.mode == "device" and len(ctl.last_fidelity) == 2
assert all(r.consumer_metrics["n"] == r.simulated_rows > 0 for r in reps)
with tempfile.TemporaryDirectory() as d:
    ctl = Controller(d, device="cpu")
    reps = ctl.run_many(
        ["traffic"], [20, 45], lambda q: {"n": sum(len(b) for b in q)},
        scale=0.002, seed=9, backend="torch", chunk_s=7)
assert ctl.last_result.mode == "device" and ctl.last_result.pipeline_s
assert all(r.consumer_metrics["n"] == r.simulated_rows > 0 and
           r.consumer_metrics["feed_chunks"] > 1 for r in reps)
with tempfile.TemporaryDirectory() as d:
    ctl = Controller(d, device="cpu")
    reps = ctl.run_many(
        ["traffic"], [20, 40], lambda q: {"n": sum(len(b) for b in q)},
        scale=0.002, seed=9, backend="torch", service=True)
assert [r.status for r in reps] == ["ok", "ok"]
assert all(fr.provenance for fr in ctl.last_fidelity)
with tempfile.TemporaryDirectory() as d:
    ctl = Controller(d, device="cpu")
    for mode in ("force", "cached"):
        rep = ctl.run("traffic", 40, lambda q: {"n": sum(len(b) for b in q)},
                      scale=0.002, seed=9, backend="torch", autotune=mode)
        assert rep.consumer_metrics["n"] == rep.simulated_rows > 0
    assert ctl.store.get_marker("_tune", "cpu-plain")["entries"]
from repro_torch.configs import get_smoke
from repro_torch.models import transformer
from repro_torch.serving import Request, ServingEngine
cfg = get_smoke("llama3-8b")
eng = ServingEngine(cfg, transformer.init_params(cfg, 0, device="cpu"),
                    slots=2, max_len=16, eos_id=-1, device="cpu")
for i in range(3):
    eng.submit(Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=4))
eng.drain()
assert eng.metrics.finished == 3
import contextlib, io
from repro_torch.launch import train
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(
        io.StringIO()):
    out = train.main(["--device", "cpu", "--arch", "llama3-8b", "--dataset",
                      "synthetic", "--steps", "3", "--ckpt-every", "2",
                      "--inject-failure", "2", "--ckpt-dir", d + "/ck",
                      "--out", d + "/m.json"])
assert out["summary"]["final_step"] == 3 and out["summary"]["restarts"] == 1
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK", len(mods))
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_torch_backend_without_device_needs_cuda(tmp_path, monkeypatch):
    from repro_torch.streamsim import Controller, Stream, metrics_batched, \
        nsa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Controller(str(tmp_path)).run(
            "traffic", 40, lambda q: {}, scale=0.002, seed=9,
            backend="torch")
    s = Stream("s", np.arange(100.0) + 1.5e9, {})
    with pytest.raises(RuntimeError, match="is_available"):
        nsa(s, 10, backend="torch")
    with pytest.raises(RuntimeError, match="is_available"):
        metrics_batched([s], [None], backend="auto")
    # the host backend needs no device
    rep = Controller(str(tmp_path / "np")).run(
        "traffic", 40, lambda q: {}, scale=0.002, seed=9, backend="numpy")
    assert rep.simulated_rows > 0


def test_controller_run_raises_on_this_host_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.streamsim import Controller
    with pytest.raises(RuntimeError):
        Controller(str(tmp_path)).run("traffic", 40, lambda q: {},
                                      scale=0.002, seed=9, backend="torch")
