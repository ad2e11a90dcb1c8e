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
        "*.py")) + [REPO / "chip_smoke.py"]


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
                "kernels/ops.py", "streamsim/engine.py",
                "streamsim/controller.py", "core/__init__.py"):
        assert mod in names
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "stream_sample.cu", "compact.cu", "metrics_fused.cu"}


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
