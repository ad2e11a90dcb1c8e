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
    """The library's path: named by a hash of the source, every header of
    ``csrc/`` (which any source may include) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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


def per_stream(cache: dict, device, make):
    """``(cache[device, current stream], stream handle)``: scratch that a
    kernel keeps between calls, one per CUDA stream so that calls on two
    streams never share it; ``make(device)`` builds it on first use."""
    import torch
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    ws = cache.get(key)
    if ws is None:
        ws = cache[key] = make(device)
    return ws, ctypes.c_void_p(stream.cuda_stream)


class LookbackWorkspace:
    """The scratch of a kernel with epoch-stamped words on one CUDA stream
    (the look-back kernels of ``csrc/lookback.cuh``, and B3/B6's span
    words): the 8-byte words and the counters (one tile counter, or one
    done-ticket a row), zeroed once when allocated and grown when a call
    needs more. Each call takes the next epoch (1, 2, ...), which makes the
    words of earlier calls unreadable to it; past ``max_epoch`` the words
    are cleared once and the count starts again. The counters are left at
    0 by every call. The lock keeps two threads that share the stream from
    taking one epoch."""

    def __init__(self, device, max_epoch: int):
        import torch
        self.device = device
        self.max_epoch = max_epoch
        self.words = torch.zeros(0, dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.epoch = 0
        self.lock = threading.Lock()

    def take(self, n_words: int, n_counters: int = 1):
        """``(status words, counters, epoch)`` for one call."""
        import torch
        with self.lock:
            if self.words.numel() < n_words:
                self.words = torch.zeros(
                    max(n_words, 2 * self.words.numel()), dtype=torch.int64,
                    device=self.device)
            if self.counter.numel() < n_counters:
                self.counter = torch.zeros(
                    max(n_counters, 2 * self.counter.numel()),
                    dtype=torch.int32, device=self.device)
            self.epoch += 1
            if self.epoch > self.max_epoch:
                self.words.zero_()
                self.epoch = 1
            return self.words, self.counter, self.epoch


class SplitWorkspace:
    """The scratch of a kernel that folds per-split partials inside its one
    launch (B5, B8) on one CUDA stream, grown when a call needs more: f32
    partials (no initial value needed) and int32 tickets, zeroed once when
    allocated; every call leaves the tickets at zero (the block that takes
    a counter's last ticket resets it)."""

    def __init__(self, device):
        import torch
        self.device = device
        self.partials = torch.empty(0, dtype=torch.float32, device=device)
        self.tickets = torch.zeros(0, dtype=torch.int32, device=device)

    def take(self, n_partials: int, n_tickets: int):
        """``(partials, tickets)`` holding at least the counts asked for."""
        import torch
        if self.partials.numel() < n_partials:
            self.partials = torch.empty(
                max(n_partials, 2 * self.partials.numel()),
                dtype=torch.float32, device=self.device)
        if self.tickets.numel() < n_tickets:
            self.tickets = torch.zeros(
                max(n_tickets, 2 * self.tickets.numel()), dtype=torch.int32,
                device=self.device)
        return self.partials, self.tickets


_sm_counts: Dict[int, int] = {}


def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    if index not in _sm_counts:
        import torch
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
