"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu``, each in a subprocess at a reduced size."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).parent.parent


def _run(name, *argv, cwd):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run([sys.executable, str(REPO / "examples" / name),
                           *argv], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


def test_quickstart_ends_in_success(tmp_path):
    out = _run("torch_quickstart.py", "--device", "cpu", cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("original: ") and "volatility=" in lines[0]
    assert lines[1].startswith("simulated: ") and "into 600s" in lines[1]
    assert lines[-1].endswith("status=success")


def test_quickstart_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _run("torch_quickstart.py", cwd=tmp_path)
    assert out.returncode != 0 and "is_available" in out.stderr
    assert "status=" not in out.stdout


def test_train_stream_recovers_from_the_injected_failure(tmp_path):
    out = _run("torch_train_stream.py", "--device", "cpu", "--steps", "3",
               "--batch", "2", "--seq", "32", "--arch", "llama3-8b",
               "--ckpt-dir", str(tmp_path / "ckpt"), cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads((tmp_path / "results" /
                      "torch_train_stream_metrics.json").read_text())
    summary = got["summary"]
    assert summary["final_step"] == 3 and summary["restarts"] == 1
    assert summary["stream"]["records_consumed"] > 0


def test_serve_loadtest_finishes_every_arrival(tmp_path):
    out = _run("torch_serve_loadtest.py", "--device", "cpu", "--arch",
               "llama3-8b", cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads((tmp_path / "results" /
                      "torch_serve_loadtest_metrics.json").read_text())
    assert got["arrivals"] > 0 and got["finished"] == got["arrivals"]
