"""The port's sweep service and static multi-host ``run_many`` against the
JAX package, on the CPU: counterpart of ``tests/test_service.py``.

The port runs ``device="cpu"`` (the kernels' plain PyTorch versions) on
the reference's grid (sogouq and traffic at 20 and 40 s, scale 0.002,
seed 9); the reference is the JAX package's direct ``run_many(backend=
"numpy")``. Contracts: rows and consumer counts equal; ``trend_corr``
within 1e-9 on the numpy backend and within the documented 1e-3 on the
torch backend; the merged fidelity matrices, recomputed by the numpy
reduction from exact count rows, within 1e-9 on either backend, with
provenance on every row. No report is poisoned unless a test poisons one
on purpose.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.streamsim import service as jservice
from repro_torch.distributed import process_topology
from repro_torch.streamsim import service as tservice
from repro_torch.streamsim.resilience import Heartbeat, Lease
from repro_torch.streamsim.service import (SweepService, merge_fidelity,
                                           pack_counts, scenario_marker,
                                           unpack_counts)
from repro_torch.streamsim.store import StreamStore

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
GRID = (["sogouq", "traffic"], [20, 40])
KW = dict(scale=0.002, seed=9)
#: report statistics of the torch backend against numpy (the engine's
#: documented backend tolerance)
TORCH_TOL = 1e-3


def _consumer(queue):
    return {"records_seen": sum(len(b) for b in queue)}


@pytest.fixture(scope="module")
def direct(tmp_path_factory):
    """The JAX package's direct single-host sweep: reports + fidelity."""
    ref = J.Controller(str(tmp_path_factory.mktemp("ref")))
    reports = ref.run_many(*GRID, _consumer, backend="numpy", **KW)
    return reports, ref.last_fidelity


def _assert_reports_equal(got, want, *, tol=1e-9, allow=("ok",)):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.dataset, a.max_range) == (b.dataset, b.max_range)
        assert a.status in allow
        assert a.original_rows == b.original_rows
        assert a.simulated_rows == b.simulated_rows
        assert a.compression == pytest.approx(b.compression)
        assert a.simulated_volatility.average == pytest.approx(
            b.simulated_volatility.average, abs=tol)
        assert a.trend_corr == pytest.approx(b.trend_corr, abs=tol,
                                             nan_ok=True)
        assert a.consumer_metrics["records_seen"] == \
            b.consumer_metrics["records_seen"]


def _assert_fidelity_full(got, want):
    assert len(got) == len(want)
    for fa, fb in zip(want, got):
        assert fa.labels == fb.labels, "merged matrix must be FULL"
        np.testing.assert_allclose(np.asarray(fb.trend_corr, float),
                                   np.asarray(fa.trend_corr, float),
                                   atol=1e-9)
        assert fb.provenance is not None and \
            len(fb.provenance) == len(fb.labels) and all(fb.provenance)


def _no_markers(store_dir):
    mroot = os.path.join(store_dir, "_markers")
    return not os.path.exists(mroot) or not [
        p for p in os.listdir(mroot) if not p.startswith(".")]


def _service(c, backend="torch", **kw):
    kw = dict(dict(service=True, lease_ttl_s=60.0, service_poll_s=0.05,
                   service_deadline_s=60.0), **kw)
    return c.run_many(*GRID, _consumer, backend=backend, **KW, **kw)


# ----------------------------------------------------- store coordination
class TestStorePrimitives:
    def test_exclusive_put_single_winner_under_race(self, tmp_path):
        store = StreamStore(str(tmp_path))
        wins = []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            if store.put_marker("g/meta", "claimant", {"w": i},
                                exclusive=True):
                wins.append(i)

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1
        assert store.get_marker("g/meta", "claimant")["w"] == wins[0]

    def test_claim_single_winner_under_race(self, tmp_path):
        store = StreamStore(str(tmp_path))
        store.put_marker("g/queue", "item", {"attempts": 0})
        wins = []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            if store.claim_marker("g/queue", "item", "g/leases", "item"):
                wins.append(i)

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1
        assert store.list_markers("g/leases") == ["item"]
        assert not store.claim_marker("g/queue", "item", "g/leases", "x")

    def test_clear_markers_is_atomic_and_recursive(self, tmp_path):
        store = StreamStore(str(tmp_path))
        for ns in ("g", "g/queue", "g/leases", "g/results"):
            store.put_marker(ns, "m", {"ns": ns})
        store.put_marker("h", "m", {})
        store.clear_markers("g")
        for ns in ("g", "g/queue", "g/leases", "g/results"):
            assert store.list_markers(ns) == []
        assert store.list_markers("h") == ["m"]


# ----------------------------------------------------------- lease protocol
class TestLeaseProtocol:
    def test_heartbeat_renews_and_drops_reaped(self, tmp_path):
        store = StreamStore(str(tmp_path))
        leases = {}
        for name in ("a__10", "b__10"):
            lease = Lease(worker="w", dataset=name[0], max_range=10,
                          ttl_s=0.3, deadline=time.time() + 0.3)
            store.put_marker("g/leases", name, lease.to_json())
            leases[name] = lease
        with Heartbeat(store, "g/leases", leases) as hb:
            time.sleep(0.5)
            store.remove_marker("g/leases", "b__10")
            time.sleep(0.5)
        assert store.get_marker("g/leases", "a__10")["beat"] >= 2
        assert "b__10" in hb.lost
        assert not store.has_marker("g/leases", "b__10")

    def test_reap_requeues_expired_and_preserves_live(self, tmp_path):
        store = StreamStore(str(tmp_path))
        svc = SweepService(store, ["a", "b"], [10], lease_ttl_s=5.0,
                           breaker_threshold=3, worker_id="me", device=CPU)
        dead = Lease(worker="gone", dataset="a", max_range=10,
                     ttl_s=5.0, deadline=time.time() - 1.0, attempts=1)
        live = Lease(worker="alive", dataset="b", max_range=10,
                     ttl_s=5.0, deadline=time.time() + 60.0, attempts=1)
        store.put_marker(svc.ns_leases, "a__10", dead.to_json())
        store.put_marker(svc.ns_leases, "b__10", live.to_json())
        assert svc.reap() == ["a__10"]
        q = store.get_marker(svc.ns_queue, "a__10")
        assert q["attempts"] == 1 and q["dataset"] == "a"
        assert store.list_markers(svc.ns_leases) == ["b__10"]
        assert svc.claim_batch(1)["a__10"].attempts == 2

    def test_reap_poisons_after_breaker_threshold(self, tmp_path):
        store = StreamStore(str(tmp_path))
        svc = SweepService(store, ["a"], [10], lease_ttl_s=5.0,
                           breaker_threshold=3, worker_id="me", device=CPU)
        doomed = Lease(worker="gone", dataset="a", max_range=10,
                       ttl_s=5.0, deadline=time.time() - 1.0, attempts=3)
        store.put_marker(svc.ns_leases, "a__10", doomed.to_json())
        svc.reap()
        assert store.list_markers(svc.ns_queue) == []
        p = store.get_marker(svc.ns_poison, "a__10")
        assert p["attempts"] == 3 and p["last_worker"] == "gone"
        assert svc.outstanding() == []

    def test_reap_handles_claim_window_crash(self, tmp_path):
        store = StreamStore(str(tmp_path))
        svc = SweepService(store, ["a"], [10], lease_ttl_s=0.05,
                           breaker_threshold=3, worker_id="me", device=CPU)
        store.put_marker(svc.ns_leases, "a__10",
                         {"dataset": "a", "max_range": 10, "attempts": 0})
        time.sleep(0.1)
        assert svc.reap() == ["a__10"]
        assert store.get_marker(svc.ns_queue, "a__10")["attempts"] == 1

    def test_group_and_markers_are_the_references(self, tmp_path):
        # the same sweep hashes to the same namespace in both packages
        a = SweepService(StreamStore(str(tmp_path)), *GRID, **KW,
                         device=CPU)
        b = jservice.SweepService(J.StreamStore(str(tmp_path)), *GRID, **KW)
        assert a.group == b.group and a.grid == b.grid
        assert [getattr(a, f"ns_{n}") for n in
                ("meta", "queue", "leases", "results", "poison",
                 "fidelity", "done")] == \
            [getattr(b, f"ns_{n}") for n in
             ("meta", "queue", "leases", "results", "poison", "fidelity",
              "done")]
        rows = [np.arange(5), np.array([2 ** 31 + 5, 0]), np.zeros(0, int)]
        for row in rows:
            assert pack_counts(row) == jservice.pack_counts(row)
            np.testing.assert_array_equal(
                unpack_counts(jservice.pack_counts(row)), row)
        assert scenario_marker("sogouq", 20.0) == \
            jservice.scenario_marker("sogouq", 20)


# ------------------------------------------------------- end-to-end service
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_single_process_service_equals_direct(tmp_path, direct, backend):
    want, fid_want = direct
    c = T.Controller(str(tmp_path / "svc"), device=CPU)
    got = _service(c, backend)
    _assert_reports_equal(got, want,
                          tol=1e-9 if backend == "numpy" else TORCH_TOL)
    _assert_fidelity_full(c.last_fidelity, fid_want)
    assert _no_markers(str(tmp_path / "svc"))
    assert len(c.list_metrics()) == len(got)
    if backend == "torch":
        assert c.last_fidelity[0].provenance[0].startswith("host0-")


def test_lease_batch_covers_whole_grid_in_one_claim(tmp_path, direct,
                                                    monkeypatch):
    batches = []
    real = tservice.SweepService.run_batch

    def spy(self, leases, *a, **kw):
        batches.append(sorted(leases))
        return real(self, leases, *a, **kw)

    monkeypatch.setattr(tservice.SweepService, "run_batch", spy)
    c = T.Controller(str(tmp_path / "svc"), device=CPU)
    got = _service(c, lease_batch=4)
    _assert_reports_equal(got, direct[0], tol=TORCH_TOL)
    assert batches == [sorted(scenario_marker(d, m) for d in GRID[0]
                              for m in GRID[1])]


def test_kill_worker_failover(tmp_path, direct):
    """SIGKILL a port worker mid-lease: its heartbeat stops, the lease
    expires, the survivor reaps and requeues it, and the sweep completes
    equal to an uninterrupted run."""
    want, fid_want = direct
    store_dir = str(tmp_path / "svc")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _ROGUE_WORKER.replace("@STORE@", store_dir)],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LEASED "), f"rogue said: {line!r}"
        leased = line.split(" ", 1)[1]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        c = T.Controller(store_dir, device=CPU)
        got = _service(c, lease_ttl_s=1.0, service_poll_s=0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
    _assert_reports_equal(got, want, tol=TORCH_TOL)
    by_name = {scenario_marker(r.dataset, r.max_range): r for r in got}
    assert by_name[leased].status == "ok"
    assert by_name[leased].consumer_metrics["records_seen"] > 0
    _assert_fidelity_full(c.last_fidelity, fid_want)


def test_poisoned_scenario_quarantined_siblings_survive(tmp_path, direct):
    want, _ = direct
    c = T.Controller(str(tmp_path / "svc"), device=CPU)
    svc = SweepService(c.store, *GRID, **KW, breaker_threshold=3,
                       worker_id="setup", device=CPU)
    svc.publish_queue()
    target = scenario_marker("sogouq", 20)
    assert c.store.claim_marker(svc.ns_queue, target, svc.ns_leases, target)
    doomed = Lease(worker="crashy", dataset="sogouq", max_range=20,
                   ttl_s=1.0, deadline=time.time() - 1.0, attempts=3)
    c.store.put_marker(svc.ns_leases, target, doomed.to_json())
    got = _service(c, breaker_threshold=3)
    assert [r.status for r in got].count("poisoned") == 1
    poisoned = next(r for r in got if r.status == "poisoned")
    assert (poisoned.dataset, poisoned.max_range) == ("sogouq", 20)
    assert poisoned.attempts == 3 and poisoned.failure
    ok = [r for r in got if r.status == "ok"]
    _assert_reports_equal(ok, [r for r in want if (r.dataset, r.max_range)
                               != ("sogouq", 20)], tol=TORCH_TOL)
    for fr in c.last_fidelity:
        if fr.max_range == 20:
            assert "sogouq/sim20" not in fr.labels


def test_a_failing_batch_is_struck_not_raised(tmp_path, monkeypatch):
    # SweepService.work keeps serving past a batch's exception: the batch
    # is struck back to the queue and, after breaker_threshold strikes,
    # poisoned; the run returns instead of raising
    def boom(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tservice.engine, "execute_sweep", boom)
    c = T.Controller(str(tmp_path / "svc"), device=CPU)
    got = c.run_many(["traffic"], [20], _consumer, backend="torch",
                     service=True, breaker_threshold=2,
                     service_deadline_s=30.0, **KW)
    assert [r.status for r in got] == ["poisoned"]
    assert "device fault" in got[0].failure and got[0].attempts == 2


def test_service_rejects_chunk_and_checkpoint(tmp_path):
    c = T.Controller(str(tmp_path), device=CPU)
    for extra in (dict(chunk_s=10), dict(checkpoint=True)):
        with pytest.raises(ValueError, match="service"):
            c.run_many(["sogouq"], [20], _consumer, backend="torch",
                       service=True, **extra, **KW)


# -------------------------------------------------- static multi-host merge
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_static_multi_host_fidelity_merges_to_full_matrix(tmp_path, direct,
                                                          backend):
    want, fid_ref = direct
    shared = str(tmp_path / "shared")
    c0 = T.Controller(shared, metrics_dir=str(tmp_path / "m0"), device=CPU)
    first = c0.run_many(*GRID, _consumer, backend=backend, n_devices=1,
                        host_index=0, n_hosts=2, **KW)
    assert 0 < len(first) < 4
    # peers' rows are still missing: the partial per-host matrices stay
    assert c0.last_fidelity and (
        len(c0.last_fidelity) < len(GRID[1]) or
        any(fr.provenance is None for fr in c0.last_fidelity))
    done = {(r.dataset, r.max_range): r for r in first}
    last = c0
    for attempt in range(1, 5):
        c = T.Controller(shared, metrics_dir=str(tmp_path / f"m{attempt}"),
                         device=CPU)
        reports = c.run_many(*GRID, _consumer, backend=backend,
                             n_devices=1, host_index=attempt % 2,
                             n_hosts=2, **KW)
        done.update({(r.dataset, r.max_range): r for r in reports})
        last = c
        if len(done) == 4:
            break
    assert len(done) == 4
    tol = 1e-9 if backend == "numpy" else TORCH_TOL
    _assert_reports_equal([done[(r.dataset, r.max_range)] for r in want],
                          want, tol=tol)
    _assert_fidelity_full(last.last_fidelity, fid_ref)
    contributors = {w for fr in last.last_fidelity for w in fr.provenance}
    assert {"host0", "host1"} <= contributors


def test_merge_fidelity_tolerates_missing_rows(tmp_path):
    store = StreamStore(str(tmp_path))
    row = np.random.default_rng(0).integers(0, 50, size=600)
    store.put_marker("g/fidelity", "orig__a",
                     {"counts": row.tolist(), "worker": "w0"})
    store.put_marker("g/fidelity", "sim__a__10",
                     {"counts": pack_counts(row[::2]), "worker": "w1"})
    out = merge_fidelity(store, "g", ["a", "b"], [10, 20])
    want = jservice.merge_fidelity(J.StreamStore(str(tmp_path)), "g",
                                   ["a", "b"], [10, 20])
    assert len(out) == len(want) == 1
    assert out[0].labels == want[0].labels == ["a/original", "a/sim10"]
    assert out[0].provenance == ["w0", "w1"]
    np.testing.assert_array_equal(np.asarray(out[0].trend_corr),
                                  np.asarray(want[0].trend_corr))
    assert np.allclose(np.diag(np.asarray(out[0].trend_corr)), 1.0)


def test_process_topology_without_a_group():
    assert process_topology()[:2] == (0, 1)
    assert process_topology()[2] >= 1


# ------------------------------------------------------ mixed-package queue
def test_mixed_package_participants_serve_one_queue(tmp_path, direct):
    """A JAX participant and a port participant take turns on one queue in
    one store: each parses the other's leases, results and count rows."""
    want, fid_want = direct
    d = str(tmp_path / "shared")
    jc, tc = J.Controller(d), T.Controller(d, device=CPU)
    origs_j = {ds: jc.prepare(ds, **KW) for ds in GRID[0]}
    origs_t = {ds: tc.prepare(ds, **KW) for ds in GRID[0]}
    js = jservice.SweepService(jc.store, *GRID, **KW, worker_id="jax")
    ts = SweepService(tc.store, *GRID, **KW, worker_id="torch", device=CPU)
    assert ts.publish_queue() and not js.publish_queue()
    turn = 0
    while True:
        svc, origs, backend = ((js, origs_j, "numpy") if turn % 2 == 0
                               else (ts, origs_t, "torch"))
        leases = svc.claim_batch()
        if not leases:
            break
        svc.run_batch(leases, origs, _consumer, backend=backend)
        turn += 1
    assert turn == 4 and not ts.outstanding() and not js.outstanding()
    rj, fj, mine_j = js.finalize(n_participants=2)
    assert not _no_markers(d)          # the port participant still reads
    rt, ft, mine_t = ts.finalize(n_participants=2)
    assert _no_markers(d)
    assert set(mine_j).isdisjoint(mine_t) and mine_j and mine_t
    assert len(set(mine_j) | set(mine_t)) == 4
    for got in (rj, rt):
        _assert_reports_equal(got, want, tol=TORCH_TOL)
    for fid in (fj, ft):
        _assert_fidelity_full(fid, fid_want)
        assert {"jax", "torch"} <= {w for fr in fid for w in fr.provenance}


# -------------------------------------------- torch.distributed 2 processes
def test_two_process_gloo_service(tmp_path, direct):
    """Two real processes in a ``gloo`` group run ``run_many(service=True)``
    against one store, their host slot and participant count taken from
    the group: both return the full grid, the work is split between them,
    and both see the merged full matrices."""
    want, _ = direct
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    store_dir = str(tmp_path / "shared")
    procs = []
    for rank in range(2):
        script = _GLOO_WORKER.replace("@STORE@", store_dir) \
            .replace("@OUT@", str(tmp_path / f"out{rank}.json")) \
            .replace("@PORT@", str(port)).replace("@RANK@", str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", script],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    payloads = [json.load(open(tmp_path / f"out{r}.json")) for r in range(2)]
    for payload in payloads:
        assert payload["topology"][:2] == [payload["rank"], 2]
        got = [T.SimulationReport.from_json(r) for r in payload["reports"]]
        _assert_reports_equal(got, want, tol=TORCH_TOL)
        for fr in payload["fidelity"]:
            assert len(fr["labels"]) == 4
            assert len(fr["provenance"]) == 4 and all(fr["provenance"])
    mine0, mine1 = (set(p["mine"]) for p in payloads)
    assert mine0.isdisjoint(mine1) and len(mine0 | mine1) == len(want)
    assert _no_markers(store_dir)


_ROGUE_WORKER = '''
import time
from repro_torch.streamsim.resilience import Heartbeat
from repro_torch.streamsim.service import SweepService
from repro_torch.streamsim.store import StreamStore

store = StreamStore("@STORE@")
svc = SweepService(store, ["sogouq", "traffic"], [20, 40], scale=0.002,
                   seed=9, lease_ttl_s=1.0, worker_id="rogue", device="cpu")
svc.publish_queue()
leases = svc.claim_batch(1)
assert leases, "rogue claimed nothing"
hb = Heartbeat(store, svc.ns_leases, leases).__enter__()
print("LEASED " + next(iter(leases)), flush=True)
time.sleep(600)   # hold the lease until SIGKILL stops the heartbeat
'''

_GLOO_WORKER = '''
import json

import torch.distributed as dist

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:@PORT@",
                        world_size=2, rank=@RANK@)
from repro_torch.distributed import process_topology
from repro_torch.streamsim import Controller
from repro_torch.streamsim.service import scenario_marker


def consumer(queue):
    return {"records_seen": sum(len(b) for b in queue)}


c = Controller("@STORE@", metrics_dir="@STORE@/_metrics@RANK@",
               device="cpu")
reports = c.run_many(["sogouq", "traffic"], [20, 40], consumer,
                     scale=0.002, seed=9, backend="torch", service=True,
                     lease_ttl_s=60.0, service_poll_s=0.05,
                     service_deadline_s=180)
mine = {(m["dataset"], m["max_range"]) for m in c.load_metrics()}
payload = {
    "rank": @RANK@, "topology": list(process_topology()),
    "reports": [r.to_json() for r in reports],
    "fidelity": [f.to_json() for f in c.last_fidelity],
    "mine": sorted(scenario_marker(*sc) for sc in mine),
}
dist.destroy_process_group()
with open("@OUT@", "w") as f:
    json.dump(payload, f)
'''
