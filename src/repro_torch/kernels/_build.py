"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
into ``lib<name>-<hash>.so`` under the package's ``_build/`` directory
(listed in ``.gitignore``) and loaded with :mod:`ctypes`. The file name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time: a
kernel is built the first time its wrapper launches it, or all at once,
in parallel, by :func:`build_all`.

A source may be built more than once, as instances of its tile sizes: a
library is keyed by ``(name, defines)``, ``defines`` a sorted tuple of
``(macro, value)`` pairs passed to ``nvcc`` as ``-Dmacro=value`` (the tile
tuner's configs, :mod:`repro_torch.kernels.tuning`). ``()`` is the default
library, built with no macro, whose tiles are the source's own defaults.

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
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: one target: Hopper with its architecture-specific features (``sm_90a``);
#: no ``--use_fast_math`` — the NSA and moment arithmetic must round as
#: the reference does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: one library: a source's name and its ``-D`` macros, sorted
Target = Tuple[str, Tuple[Tuple[str, int], ...]]

_lock = threading.Lock()
_libs: Dict[Target, ctypes.CDLL] = {}
#: ``nvcc`` standard error of each build (``-Xptxas -v`` register and
#: shared-memory report), by kernel name (a source with macros: the name
#: and the macros, as :func:`label` gives them)
build_logs: Dict[str, str] = {}
#: seconds each build took, by the same label
build_seconds: Dict[str, float] = {}


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


def label(target: Target) -> str:
    """``name`` for a default library, ``name[MACRO=value,...]`` else."""
    name, defines = target
    if not defines:
        return name
    return f"{name}[{','.join(f'{k}={v}' for k, v in defines)}]"


def _flags(defines) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={int(v)}" for k, v in defines)


def _path(target: Target) -> Path:
    """The library's path: named by a hash of the source, every header of
    ``csrc/`` (which any source may include) and the flags, macros
    included."""
    name, defines = target
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(repr(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(target: Target):
    """Start ``nvcc`` for one library unless it is already built. Returns
    ``(process, temporary output path, start time)`` or None; the output
    is renamed into place by :func:`_finish`."""
    if _path(target).exists():
        return None
    nvcc = nvcc_path()          # raises before any file is created
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    name, defines = target
    try:
        proc = subprocess.Popen(
            [nvcc, *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except BaseException:
        os.unlink(tmp)
        raise
    return proc, tmp, time.perf_counter()


def _finish(target: Target, started) -> None:
    if started is None:
        return
    proc, tmp, t0 = started
    key = label(target)
    try:
        out, err = proc.communicate()
        build_seconds[key] = time.perf_counter() - t0
        build_logs[key] = (out or "") + (err or "")
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {key} (exit {proc.returncode}):\n"
                f"{build_logs[key]}")
        os.replace(tmp, _path(target))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def target(name: str, defines=()) -> Target:
    """``(name, defines)`` with the macros sorted, as libraries are keyed."""
    return name, tuple(sorted((str(k), int(v)) for k, v in defines))


def build_many(targets: Iterable) -> Dict[Target, str]:
    """Compile every target (a source name, or ``(name, defines)``) not yet
    built, one ``nvcc`` process each, all started together; returns the
    error of each build that failed (empty when all succeeded). A start
    that fails (no toolkit, or ``nvcc`` not runnable: ``OSError``) is a
    failure of its target; every process already started is still waited
    for, and no temporary output is left behind."""
    targets = [target(t) if isinstance(t, str) else target(*t)
               for t in targets]
    failed: Dict[Target, str] = {}
    with _lock:
        started = []
        for t in dict.fromkeys(targets):
            try:
                started.append((t, _start(t)))
            except (KernelBuildError, OSError) as e:
                failed[t] = str(e)
        for t, st in started:
            try:
                _finish(t, st)
            except (KernelBuildError, OSError) as e:
                failed[t] = str(e)
    return failed


def build_all(names: Optional[Iterable[str]] = None,
              instances: Iterable = ()) -> None:
    """Compile every named source (default: all of ``csrc/``) and every
    ``(name, defines)`` instance with one ``nvcc`` process each, all
    started together, and wait for them; raises if any build failed."""
    names = list(kernel_names() if names is None else names)
    failed = build_many([*names, *instances])
    if failed:
        raise KernelBuildError("\n".join(failed.values()))


def library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with ``defines`` (a
    sequence of ``(macro, value)``; empty: the default library), built on
    first use."""
    key = target(name, defines)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key not in _libs:
            _finish(key, _start(key))
            _libs[key] = ctypes.CDLL(str(_path(key)))
        return _libs[key]


def bind(name: str, symbol: str, argtypes, defines=()) -> ctypes._CFuncPtr:
    """One C entry point of the library :func:`library` gives, with its
    argument types declared (pointers and the stream as ``c_void_p`` so
    ctypes never truncates them)."""
    fn = getattr(library(name, defines), symbol)
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
