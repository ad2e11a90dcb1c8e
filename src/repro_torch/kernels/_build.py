"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
into ``lib<name>-<hash>.so`` under the package's ``_build/`` directory
(listed in ``.gitignore``) and loaded with :mod:`ctypes`. The file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time: a
kernel is built the first time its wrapper launches it, or all at once,
in parallel, by :func:`build_all`.

The C entry points take every device pointer and the CUDA stream as
``void*`` and return ``cudaGetLastError()`` after the launch; :func:`check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: one target: Hopper with its architecture-specific features (``sm_90a``);
#: no ``--use_fast_math`` — the NSA and moment arithmetic must round as
#: the reference does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` standard error of each build (``-Xptxas -v`` register and
#: shared-memory report), by kernel name
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` failed, or no CUDA toolkit was found."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is already built.
    Returns ``(process, temporary output path)`` or None; the output is
    renamed into place by :func:`_finish`."""
    if _target(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp = started
    try:
        out, err = proc.communicate()
        build_logs[name] = (out or "") + (err or "")
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{build_logs[name]}")
        os.replace(tmp, _target(name))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile every named source (default: all of ``csrc/``) with one
    ``nvcc`` process each, all started together, and wait for them."""
    names = list(kernel_names() if names is None else names)
    with _lock:
        started = [(n, _start(n)) for n in names]
        errors = []
        for n, st in started:
            try:
                _finish(n, st)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """One C entry point with its argument types declared (pointers and
    the stream as ``c_void_p`` so ctypes never truncates them)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
