"""The kernel build helpers of the port (``repro_torch.kernels._build``) on
a host without a usable CUDA toolkit: a start that fails leaves no
temporary output behind, and ``build_many`` reports it as a failure after
waiting for every ``nvcc`` process it had already started."""

import pytest

from repro_torch.kernels import _build

TARGETS = ["compact", "trend_scan", "flash_decode"]


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    return tmp_path


def _leftovers(build_dir):
    return sorted(p.name for p in build_dir.iterdir())


def test_missing_nvcc_is_a_failure_and_leaves_no_file(build_dir,
                                                      monkeypatch):
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    failed = _build.build_many(TARGETS)
    assert sorted(name for name, _ in failed) == sorted(TARGETS)
    assert all("nvcc not found" in e for e in failed.values())
    assert _leftovers(build_dir) == []
    # the single-target path raises and leaves nothing either
    with pytest.raises(_build.KernelBuildError):
        _build.library("compact", (("TILE_TEST", 1),))
    assert _leftovers(build_dir) == []


class _Proc:
    """A started ``nvcc`` that failed to compile."""

    def __init__(self):
        self.returncode = None
        self.waited = False

    def communicate(self):
        self.waited = True
        self.returncode = 1
        return "", "error: stub"


def test_popen_oserror_after_one_start(build_dir, monkeypatch):
    started = []

    def popen(cmd, **kw):
        if started:
            raise OSError(8, "Exec format error", cmd[0])
        started.append(_Proc())
        return started[0]

    monkeypatch.setattr(_build, "nvcc_path", lambda: "/nonexistent/nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    failed = _build.build_many(TARGETS)
    assert len(started) == 1 and started[0].waited
    assert sorted(name for name, _ in failed) == sorted(TARGETS)
    first = _build.target(TARGETS[0])
    assert "nvcc failed" in failed[first]
    assert all("Exec format error" in e for t, e in failed.items()
               if t != first)
    assert not list(build_dir.glob("*.so.tmp"))
    assert _leftovers(build_dir) == []
