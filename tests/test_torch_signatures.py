"""Signatures of the port's sweep entry points and of its training stack
against the JAX package's.

A keyword the reference takes must be taken by the port too, never
``TypeError``: ``autotune`` runs every mode the reference has ("cached"
and "force" give the "off" results, an unknown mode raises ``ValueError``
as the reference's tuner does) and the sweep service's lease knobs reach
the service. The comparison of the signatures is made here, in the test
only; the port imports nothing of the reference.
"""

import dataclasses
import functools
import importlib
import inspect
import re
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.streamsim as J
import repro_torch.streamsim as T
from repro.streamsim import engine as jengine
from repro_torch.streamsim import engine as tengine

# the packages export a function ``nsa`` that hides the module of that name
jnsa = importlib.import_module("repro.streamsim.nsa")
tnsa = importlib.import_module("repro_torch.streamsim.nsa")

CPU = "cpu"
SCALE, SEED = 0.002, 9

#: the sweep service's lease knobs, each at a value other than its default
LEASE_KNOBS = {"lease_ttl_s": 5.0, "service_poll_s": 1.0, "lease_batch": 2,
               "worker_id": "w0", "service_deadline_s": 30.0}


def _drain(queue):
    return {"records_seen": sum(len(b) for b in queue)}


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def test_run_many_signature_is_the_references():
    """Keyword for keyword: names, order, kinds and defaults."""
    assert _params(T.Controller.run_many) == _params(J.Controller.run_many)


@pytest.mark.parametrize("port,ref", [
    (tnsa.nsa_sweep_device, jnsa.nsa_sweep_device),
    (tnsa.ChunkedNSA.__init__, jnsa.ChunkedNSA.__init__),
    (tengine.DeviceSweepResult.__init__, jengine.DeviceSweepResult.__init__),
    (tengine.execute_sweep, jengine.execute_sweep),
    (tengine.ChunkedSweepRunner.__init__, jengine.ChunkedSweepRunner.__init__),
], ids=["nsa_sweep_device", "ChunkedNSA", "DeviceSweepResult",
        "execute_sweep", "ChunkedSweepRunner"])
def test_autotune_keyword_is_the_references(port, ref):
    want = inspect.signature(ref).parameters["autotune"]
    got = inspect.signature(port).parameters["autotune"]
    assert want.default is None
    assert (got.kind, got.default) == (want.kind, want.default)


@pytest.mark.parametrize("name", sorted(LEASE_KNOBS))
def test_lease_knob_other_than_default_raises(tmp_path, monkeypatch, name):
    # (the name is kept from when the knobs raised NotImplementedError)
    # each knob now reaches the sweep service: seen on the service that
    # runs the batches, in the leases it writes, or in provenance
    from repro_torch.streamsim import service as tservice

    seen = {"batches": []}
    run_batch, work = tservice.SweepService.run_batch, \
        tservice.SweepService.work

    def spy_batch(self, leases, *a, **kw):
        seen["batches"].append(sorted(leases))
        seen["ttl"] = {lease.ttl_s for lease in leases.values()}
        seen["poll_s"], seen["worker"] = self.poll_s, self.worker_id
        return run_batch(self, leases, *a, **kw)

    def spy_work(self, *a, **kw):
        seen["deadline_s"] = kw.get("deadline_s")
        return work(self, *a, **kw)

    monkeypatch.setattr(tservice.SweepService, "run_batch", spy_batch)
    monkeypatch.setattr(tservice.SweepService, "work", spy_work)
    c = T.Controller(str(tmp_path), device=CPU)
    value = LEASE_KNOBS[name]
    reps = c.run_many(["traffic"], [20, 40], _drain, scale=SCALE, seed=SEED,
                      backend="torch", service=True, **{name: value})
    assert [r.status for r in reps] == ["ok", "ok"]
    assert all(r.consumer_metrics["records_seen"] == r.simulated_rows > 0
               for r in reps)
    assert len(c.list_metrics()) == 2
    if name == "lease_batch":
        assert seen["batches"] == [["traffic__20", "traffic__40"]]
    else:
        assert seen["batches"] == [["traffic__20"], ["traffic__40"]]
    if name == "worker_id":
        assert seen["worker"] == value
        assert {w for fr in c.last_fidelity for w in fr.provenance} == {value}
    want = {"lease_ttl_s": ("ttl", {value}),
            "service_poll_s": ("poll_s", value),
            "service_deadline_s": ("deadline_s", value)}
    if name in want:
        key, expect = want[name]
        assert seen[key] == expect


def test_lease_knobs_at_their_defaults_change_nothing(tmp_path):
    defaults = {name: inspect.signature(J.Controller.run_many)
                .parameters[name].default for name in LEASE_KNOBS}
    kw = dict(scale=SCALE, seed=SEED, backend="torch")
    (a,) = T.Controller(str(tmp_path / "a"), device=CPU).run_many(
        ["traffic"], [20], _drain, **kw)
    (b,) = T.Controller(str(tmp_path / "b"), device=CPU).run_many(
        ["traffic"], [20], _drain, **kw, **defaults)
    assert a.simulated_rows == b.simulated_rows > 0
    assert a.consumer_metrics == b.consumer_metrics
    assert a.simulated_volatility == b.simulated_volatility


def test_argument_checks_come_before_the_lease_raise(tmp_path):
    # (the name is kept from when the lease knobs raised): the reference's
    # argument checks still come first, before any stream is prepared,
    # and the service's own checks before any batch runs
    c = T.Controller(str(tmp_path), device=CPU)
    with pytest.raises(ValueError, match="duration_s"):
        c.run_many(["traffic"], [20], _drain, duration_s=86_400,
                   lease_batch=2)
    with pytest.raises(ValueError, match="service"):
        c.run_many(["traffic"], [20], _drain, service=True, lease_batch=2,
                   checkpoint=True)
    assert c.store.list() == []
    for bad in (dict(lease_batch=0), dict(lease_ttl_s=0.0)):
        with pytest.raises(ValueError, match="lease"):
            c.run_many(["traffic"], [20], _drain, scale=SCALE, seed=SEED,
                       backend="torch", service=True, **bad)
    assert c.list_metrics() == []


@pytest.fixture(scope="module")
def originals():
    return {"traffic": T.preprocess(T.make_stream("traffic", scale=SCALE,
                                                  seed=SEED))}


def _plan(originals, store):
    return T.plan_sweep(store, ["traffic"], [20], {"traffic": len(
        originals["traffic"])}, n_devices=1, host_index=0, n_hosts=1,
        force=True)


def _sweep_device(originals, autotune):
    return tnsa.nsa_sweep_device(originals, [("traffic", 20)], device=CPU,
                                 autotune=autotune)


def _chunked_nsa(originals, autotune):
    return T.ChunkedNSA(originals, [("traffic", 20)], device=CPU,
                        autotune=autotune)


def _sweep_result(originals, autotune):
    return T.DeviceSweepResult(_plan(originals, None), originals, None,
                               "torch", "device", device=CPU,
                               autotune=autotune)


@pytest.mark.parametrize("make", [_sweep_device, _chunked_nsa,
                                  _sweep_result],
                         ids=["nsa_sweep_device", "ChunkedNSA",
                              "DeviceSweepResult"])
@pytest.mark.parametrize("autotune,raises", [
    (None, None), ("off", None), ("cached", None), ("force", None),
    ("fastest", ValueError)])
def test_autotune_modes(originals, make, autotune, raises):
    # every mode runs and gives the "off" outputs; an unknown one raises
    # where the device leg enters the tuner (the sweep's launches, the
    # first chunk, the original's metrics)
    def leg(out):
        if make is _sweep_device:
            return out
        if make is _chunked_nsa:
            return out.chunk(0, 20)
        return out.om["traffic"]

    if raises is not None:
        with pytest.raises(raises, match="autotune"):
            leg(make(originals, autotune))
        return
    got, want = leg(make(originals, autotune)), leg(make(originals, None))
    if make is _sweep_device:
        ss_kept, idx, totals, lengths = got
        ref_ss, ref_idx, ref_totals, _ = want
        assert np.array_equal(totals, ref_totals) and totals[0] > 0
        assert np.array_equal(idx.numpy(), ref_idx.numpy())
        assert np.array_equal(ss_kept.numpy(), ref_ss.numpy())
    elif make is _chunked_nsa:
        assert int(got.totals.sum()) == int(got.kept.sum()) > 0
        assert np.array_equal(got.idx.numpy(), want.idx.numpy())
        assert np.array_equal(got.ss_kept.numpy(), want.ss_kept.numpy())
    else:
        assert np.array_equal(got.counts, want.counts)
        np.testing.assert_allclose(got.volatility.variance,
                                   want.volatility.variance, rtol=1e-5)


def test_execute_sweep_threads_autotune(originals, tmp_path):
    # "force" measures and persists a winner for every key the sweep
    # dispatches, under the store; the reports equal the "off" run's
    store = T.StreamStore(tmp_path / "store")
    res = T.execute_sweep(_plan(originals, None), originals, None,
                          backend="torch", device=CPU, autotune="off")
    forced = T.execute_sweep(_plan(originals, store), originals, store,
                             backend="torch", device=CPU, autotune="force")
    assert res.mode == forced.mode == "device"
    assert np.array_equal(res.shard_results[0].totals,
                          forced.shard_results[0].totals)
    np.testing.assert_allclose(forced.shard_results[0].mom,
                               res.shard_results[0].mom, rtol=1e-5)
    entries = store.get_marker("_tune", "cpu-plain")["entries"]
    assert {k.split("/")[0] for k in entries} == {
        "stream_sample", "compact", "metrics_fused"}
    with pytest.raises(ValueError, match="autotune"):
        T.execute_sweep(_plan(originals, None), originals, None,
                        backend="torch", device=CPU, autotune="fastest")


# ------------------------------------------------------------------ training
TRAINING_NAMES = {
    "training.optimizer": ("adamw_init", "_schedule", "global_norm",
                           "adamw_update"),
    "training.steps": ("make_train_step", "make_forward_step",
                       "make_serve_step", "jit_train_step", "jit_serve_step",
                       "jit_prefill_step"),
    "training.checkpoint": ("CheckpointManager.__init__",
                            "CheckpointManager.save",
                            "CheckpointManager.wait",
                            "CheckpointManager.steps",
                            "CheckpointManager.latest_step",
                            "CheckpointManager.restore",
                            "CheckpointManager.manifest"),
    "training.ft": ("SimulatedFailure.__init__", "FailureInjector.check",
                    "StragglerMonitor.observe", "StragglerMonitor.summary",
                    "elastic_plan"),
    "training.train_loop": ("TrainLoop.__init__", "TrainLoop.run",
                            "TrainLoop.summary"),
    "models.transformer": ("forward", "lm_loss", "loss_fn", "_remat",
                           "param_specs"),
    "launch.train": ("build_batches",),
    "distributed.sharding": ("_param_spec", "param_pspecs", "batch_pspec",
                             "cache_pspecs", "activation_rules",
                             "_axis_size", "_dp", "_fits", "_maybe"),
    "distributed.api": ("sharding_rules", "active_rules", "constrain",
                        "process_topology"),
    "distributed.compression": ("quantize", "dequantize", "compressed_psum",
                                "make_compressed_dp_grad", "ef_init"),
    "launch.mesh": ("make_production_mesh",),
    "configs": ("input_specs", "cell_supported"),
}
TRAINING_DATACLASSES = [("training.optimizer", "AdamW"),
                        ("training.ft", "FailureInjector"),
                        ("training.ft", "StragglerMonitor"),
                        ("training.train_loop", "TrainLoopConfig")]


def _both(mod, name):
    get = lambda pkg: functools.reduce(
        getattr, name.split("."), importlib.import_module(f"{pkg}.{mod}"))
    return get("repro_torch"), get("repro")


#: parameters the port adds after the reference's: the device of the
#: production mesh (``None``: CUDA; the dry-run's tests pass ``"cpu"``)
TRAINING_EXTRA = {("launch.mesh", "make_production_mesh"): [
    ("device", inspect.Parameter.KEYWORD_ONLY, None)]}


@pytest.mark.parametrize("mod,name", [
    (mod, name) for mod, names in TRAINING_NAMES.items() for name in names],
    ids=lambda x: x)
def test_training_signatures_are_the_references(mod, name):
    """Names, order, kinds and defaults (plus :data:`TRAINING_EXTRA`)."""
    port, ref = _both(mod, name)
    assert _params(port) == _params(ref) + TRAINING_EXTRA.get((mod, name),
                                                               [])


@pytest.mark.parametrize("mod,cls", TRAINING_DATACLASSES, ids=lambda x: x)
def test_training_dataclass_fields_are_the_references(mod, cls):
    fields = lambda c: [(f.name, f.type, f.default)
                        for f in dataclasses.fields(c)]
    port, ref = _both(mod, cls)
    assert fields(port) == fields(ref)


def test_host_mesh_takes_the_references_arguments_and_a_device():
    """``make_host_mesh(data, model)`` as the reference's, and ``device``
    (``None``: CUDA; ``"cpu"``: a gloo mesh)."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    assert _params(tmesh.make_host_mesh) == _params(jmesh.make_host_mesh) + [
        ("device", inspect.Parameter.POSITIONAL_OR_KEYWORD, None)]


def test_distributed_package_exports_the_references_names():
    import repro.distributed as jd
    import repro_torch.distributed as td
    names = {n for n in vars(jd) if not n.startswith("_")} - {
        "api", "sharding"}
    assert names <= set(vars(td))


def test_training_package_exports_the_references_names():
    import repro.training as jt
    import repro_torch.training as tt
    names = {n for n in vars(jt) if not n.startswith("_")} - {"data"}
    assert names <= set(vars(tt))


def _cli_flags(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train", "--help"])
    with pytest.raises(SystemExit):
        main(*argv)
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


def test_train_launcher_flags_are_the_references(capsys, monkeypatch):
    """``main(argv)`` takes an argument list (the reference's reads
    ``sys.argv``): its flags are the reference's and ``--device``."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    assert _params(jtrain.main) == []
    assert _params(ttrain.main) == [
        ("argv", inspect.Parameter.POSITIONAL_OR_KEYWORD, None)]
    want = _cli_flags(jtrain.main, (), capsys, monkeypatch)
    got = _cli_flags(ttrain.main, (["--help"],), capsys, monkeypatch)
    assert "--inject-failure" in want
    assert got == want | {"--device"}
