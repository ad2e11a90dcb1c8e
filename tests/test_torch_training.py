"""The port's training stack against the JAX package on the CPU.

Counterparts of ``tests/test_training.py``'s optimizer, checkpoint,
fault-tolerance and stream-training tests, plus parity with the
reference: the same parameters (the reference's ``init_params``, carried
over with ``params_from_numpy``) and the same numpy batches go through
both packages.

Tolerances: one AdamW update 1e-6 relative, new params, m and v leaf by
leaf within 1e-6 of the leaf's largest magnitude (the same f32
operations in the same order; XLA and PyTorch may round a
transcendental or fuse a multiply-add one ulp apart, which
``p - lr * delta`` magnifies where the two nearly cancel); per-step losses over five train steps 1e-4
relative, and at the end each leaf of params, m and v within 1e-5 of
its norm (gradients are summed in another order by XLA and by autograd;
element by element, Adam's step of about ``lr`` on a gradient near zero
can take that gradient's sign from either side). Checkpoints, restarts
and ``donate`` are held bit for bit.
"""

import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.paper_stream import consumer_lm as j_consumer_lm
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch import tree
from repro_torch.configs.paper_stream import consumer_lm
from repro_torch.models import transformer as T
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import StreamBatcher, SyntheticBatcher
from repro_torch.training.ft import (FailureInjector, StragglerMonitor,
                                     elastic_plan)
from repro_torch.training.optimizer import (AdamW, adamw_init, adamw_update,
                                            adamw_update_in_place)
from repro_torch.training.steps import (jit_prefill_step, jit_serve_step,
                                        jit_train_step, make_train_step)
from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig

CPU = "cpu"
LOSS_RTOL = 1e-4
UPDATE_RTOL = 1e-6
STATE_TOL = 1e-5


def tiny_lm(lm=consumer_lm):
    return lm().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, loss_chunk=16)


def make_state(cfg, seed=0):
    params = T.init_params(cfg, seed, device=CPU)
    return params, adamw_init(params)


def _pair(seed=0):
    """(JAX params, port params) of the same weights, tiny_lm."""
    jp = JT.init_params(tiny_lm(j_consumer_lm), jax.random.PRNGKey(seed))
    return jp, T.params_from_numpy(tiny_lm(), jax.tree.map(np.asarray, jp),
                                   CPU)


def _batches(n, seed=0, cfg=None):
    cfg = cfg or tiny_lm()
    it = iter(SyntheticBatcher(4, 32, cfg.vocab_size, seed=seed))
    return [next(it) for _ in range(n)]


def _clone(t):
    return tree.tree_map(torch.clone, t)


def _bits(t):
    t = t.detach().reshape(-1)
    return t.view(torch.int16) if t.element_size() == 2 else t.view(
        {4: torch.int32, 8: torch.int64, 1: torch.int8}[t.element_size()])


def _bit_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and
        torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _close(jtree, ttree, rtol):
    """Leaf by leaf within ``rtol`` relative, and ``rtol`` times the
    leaf's largest magnitude absolute."""
    jl, tl = jax.tree.leaves(jtree), tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a, np.float64)
        np.testing.assert_allclose(b.double().numpy(), a, rtol=rtol,
                                   atol=rtol * np.abs(a).max())


# ---------------------------------------------------------------- optimizer
class TestOptimizer:
    def test_descends_on_fixed_batch(self):
        cfg = tiny_lm()
        params, opt_state = make_state(cfg)
        opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=60)
        step = jit_train_step(cfg, opt, mesh=None, donate=False)
        batch = next(iter(SyntheticBatcher(4, 32, cfg.vocab_size)))
        losses = []
        for _ in range(25):
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.7, f"no descent: {losses[::6]}"

    def test_grad_clip(self):
        cfg = tiny_lm()
        params, opt_state = make_state(cfg)
        g = tree.tree_map(lambda p: torch.full(p.shape, 100.0), params)
        _, _, stats = adamw_update(AdamW(grad_clip=1.0), g, opt_state,
                                   params)
        assert float(stats["grad_norm"]) > 1.0  # recorded pre-clip

    @pytest.mark.parametrize("step", [0, 3, 150])
    def test_update_matches_reference(self, step):
        # one update on identical inputs: warm-up, and past it on the
        # cosine (total_steps 200 so step 150 is mid-decay), clipped grads
        jp, tp = _pair()
        rng = np.random.default_rng(step)
        g = jax.tree.map(lambda p: rng.normal(0, 0.05, p.shape).astype(
            np.float32), jp)
        m = jax.tree.map(lambda p: rng.normal(0, 1e-2, p.shape).astype(
            np.float32), jp)
        v = jax.tree.map(lambda p: rng.uniform(0, 1e-3, p.shape).astype(
            np.float32), jp)
        state = {"step": np.int32(step), "m": m, "v": v}
        opt = dict(lr=1e-3, warmup_steps=10, total_steps=200)
        jnew, jst, jstats = jopt.adamw_update(
            jopt.AdamW(**opt), jax.tree.map(jnp.asarray, g),
            jax.tree.map(jnp.asarray, state), jp)
        tstate = T.opt_state_from_numpy(tiny_lm(), state, CPU)
        tnew, tst, tstats = adamw_update(
            AdamW(**opt), T.params_from_numpy(tiny_lm(), g, CPU), tstate, tp)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        assert tst["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=UPDATE_RTOL)
        _close(jnew, tnew, UPDATE_RTOL)
        _close(jst["m"], tst["m"], UPDATE_RTOL)
        _close(jst["v"], tst["v"], UPDATE_RTOL)

    def test_in_place_update_equals_update(self):
        params, opt_state = make_state(tiny_lm())
        opt_state["step"].fill_(4)
        g = tree.tree_map(lambda p: torch.randn(
            p.shape, generator=torch.Generator().manual_seed(p.numel())),
            params)
        want_p, want_s, want = adamw_update(AdamW(), g, opt_state, params)
        p2, s2 = _clone(params), _clone(opt_state)
        got_p, got_s, got = adamw_update_in_place(AdamW(), g, s2, p2)
        assert got_p is p2 and got_s is s2
        assert _bit_equal(got_p, want_p) and _bit_equal(got_s, want_s)
        assert float(got["lr"]) == float(want["lr"])


# --------------------------------------------------------------- parity
def test_train_steps_match_reference():
    """Five train steps from the same parameters and batches: each loss
    within 1e-4 relative, params/m/v close at the end."""
    jp, tp = _pair()
    jo, to = jopt.adamw_init(jp), adamw_init(tp)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=60)
    jstep = jsteps.jit_train_step(tiny_lm(j_consumer_lm),
                                  jopt.AdamW(**kw), donate=False)
    tstep = jit_train_step(tiny_lm(), AdamW(**kw), donate=False)
    for b in _batches(5, seed=3):
        jp, jo, jm = jstep(jp, jo, b)
        tp, to, tm = tstep(tp, to, b)
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL)
    assert int(to["step"]) == int(jo["step"]) == 5
    for jt, tt in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
        for a, b in zip(jax.tree.leaves(jt), tree.leaves(tt)):
            a = np.asarray(a, np.float64)
            assert np.linalg.norm(b.double().numpy() - a) <= \
                STATE_TOL * np.linalg.norm(a)


@pytest.mark.parametrize("donate", [False, True])
def test_donate(donate):
    """donate=False leaves params and state as they were, bit for bit;
    donate=True writes the same results into them."""
    cfg = tiny_lm()
    params, opt_state = make_state(cfg)
    before_p, before_s = _clone(params), _clone(opt_state)
    step = jit_train_step(cfg, AdamW(lr=1e-3, warmup_steps=1),
                          donate=donate)
    batch = _batches(1)[0]
    new_p, new_s, _ = step(params, opt_state, batch)
    ref_p, ref_s, _ = make_train_step(cfg, AdamW(lr=1e-3, warmup_steps=1))(
        before_p, _clone(before_s), batch)
    assert _bit_equal(new_p, ref_p) and _bit_equal(new_s, ref_s)
    assert not _bit_equal(new_p, before_p)
    if donate:
        assert new_p is params and _bit_equal(params, ref_p)
    else:
        assert _bit_equal(params, before_p)
        assert _bit_equal(opt_state, before_s)


def test_jit_steps_with_a_mesh_raise():
    # (the name is kept from when every mesh raised): a mesh that is not
    # a DeviceMesh with named dims raises TypeError; the sharded steps
    # themselves are held to the unsharded ones in
    # tests/test_torch_distributed.py
    cfg = tiny_lm()
    for mesh in (object(), (2, 2)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            jit_train_step(cfg, AdamW(), mesh=mesh)
        with pytest.raises(TypeError, match="DeviceMesh"):
            jit_serve_step(cfg, mesh=mesh)
        with pytest.raises(TypeError, match="DeviceMesh"):
            jit_prefill_step(cfg, mesh=mesh)


def test_serve_and_prefill_steps():
    """The serve step without donation leaves the cache as it was; with
    it, it writes the cache in place; the prefill step gives the last
    position's logits of the forward pass."""
    cfg = tiny_lm()
    params = T.init_params(cfg, 1, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 8)).astype(np.int32))
    logits, cache = jit_prefill_step(cfg)(params, toks, torch.tensor([8, 8]))
    hidden, _ = T.forward(cfg, params, toks)
    full = T.unembed(hidden[:, -1], T._head_table(cfg, params))
    torch.testing.assert_close(logits, full, rtol=1e-4, atol=1e-4)
    before = _clone(cache)
    out, kept = jit_serve_step(cfg, donate=False)(params, cache,
                                                  toks[:, -1])
    assert _bit_equal(cache, before) and kept is not cache
    out2, same = jit_serve_step(cfg)(params, cache, toks[:, -1])
    assert same is cache and int(cache["pos"][0]) == 9
    torch.testing.assert_close(out, out2)


# --------------------------------------------------------------- checkpoint
class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        params, opt_state = make_state(tiny_lm())
        mgr = CheckpointManager(tmp_path, keep=2)
        mgr.save(3, {"params": params, "opt": opt_state})
        state = mgr.restore({"params": params, "opt": opt_state})
        assert _bit_equal(state, {"params": params, "opt": opt_state})
        assert state["opt"]["step"].dtype == torch.int32

    def test_gc_and_latest(self, tmp_path):
        params, _ = make_state(tiny_lm())
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"p": params})
        assert mgr.steps() == [3, 4]
        assert mgr.latest_step() == 4

    def test_async_save(self, tmp_path):
        params, _ = make_state(tiny_lm())
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"p": params}, blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_async_save_copies_before_handing_off(self, tmp_path):
        # an in-place update right after save(blocking=False) (a donated
        # step) must not reach the checkpoint being written
        params, _ = make_state(tiny_lm())
        want = _clone(params)
        mgr = CheckpointManager(tmp_path)
        gate = threading.Event()
        write = mgr._write
        mgr._write = lambda *a: (gate.wait(10), write(*a))
        mgr.save(1, {"p": params}, blocking=False)
        for t in tree.leaves(params):
            t.add_(1.0)
        gate.set()
        mgr.wait()
        assert _bit_equal(mgr.restore({"p": params})["p"], want)

    def test_shape_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"w": torch.zeros((4, 4))})
        with pytest.raises(ValueError):
            mgr.restore({"w": torch.zeros((8, 8))})
        with pytest.raises(KeyError):
            mgr.restore({"x": torch.zeros((4, 4))})
        # a shardings tree whose structure is not like's
        with pytest.raises(ValueError, match="structure"):
            mgr.restore({"w": torch.zeros((4, 4))}, shardings={"x": None})
        with pytest.raises(ValueError, match="structure"):
            mgr.restore({"w": torch.zeros((4, 4))},
                        shardings={"w": [None, None]})
        with pytest.raises(TypeError, match="NamedSharding"):
            mgr.restore({"w": torch.zeros((4, 4))}, shardings={"w": None})

    def test_bf16_roundtrip_is_bit_exact(self, tmp_path):
        cfg = tiny_lm().replace(dtype="bfloat16")
        params, opt_state = make_state(cfg)
        # every 16-bit pattern, NaNs, infinities and -0 included
        params["embed"].view(torch.int16).copy_(torch.arange(
            -2**15, 2**15, 2, dtype=torch.int32)
            .to(torch.int16).reshape(params["embed"].shape))
        state = {"params": params, "opt": opt_state}
        mgr = CheckpointManager(tmp_path)
        mgr.save(7, state)
        leaves = mgr.manifest(7)["leaves"]
        assert leaves["params/embed"]["dtype"] == "bfloat16"
        assert leaves["opt/m/embed"]["dtype"] == "float32"
        assert leaves["opt/step"]["dtype"] == "int32"
        with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
            assert z["params/embed"].dtype == np.uint16
        got = mgr.restore(state)
        assert got["params"]["embed"].dtype == torch.bfloat16
        assert _bit_equal(got, state)

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        # f32 both ways: written by the reference, read by the port, equal
        # to params_from_numpy of the same arrays; and back
        jp, tp = _pair(seed=4)
        jo = jopt.adamw_init(jp)
        jckpt.CheckpointManager(tmp_path / "j").save(
            5, {"params": jp, "opt": jo})
        like = {"params": T.init_params(tiny_lm(), 9, device=CPU),
                "opt": adamw_init(tp)}
        got = CheckpointManager(tmp_path / "j").restore(like)
        assert _bit_equal(got["params"], tp)
        assert _bit_equal(got["opt"], T.opt_state_from_numpy(
            tiny_lm(), jax.tree.map(np.asarray, jo), CPU))

        CheckpointManager(tmp_path / "t").save(
            6, {"params": tp, "opt": adamw_init(tp)})
        back = jckpt.CheckpointManager(tmp_path / "t").restore(
            {"params": jp, "opt": jo})
        for a, b in zip(jax.tree.leaves(back["params"]),
                        jax.tree.leaves(jp)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(back["opt"]["step"]) == 0
        assert (jckpt.CheckpointManager(tmp_path / "t").manifest(6)[
            "leaves"].keys() == jckpt.CheckpointManager(tmp_path / "j")
            .manifest(5)["leaves"].keys())

    def test_reference_bf16_checkpoint_restores_bit_for_bit(self, tmp_path):
        # the reference writes a bf16 leaf as numpy's 2-byte void type,
        # which it cannot read back itself; the port reads it
        jp = JT.init_params(tiny_lm(j_consumer_lm).replace(
            dtype="bfloat16"), jax.random.PRNGKey(2))
        jckpt.CheckpointManager(tmp_path).save(1, {"params": jp})
        cfg = tiny_lm().replace(dtype="bfloat16")
        want = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), CPU)
        got = CheckpointManager(tmp_path).restore({"params": want})
        assert _bit_equal(got["params"], want)

    def test_params_to_numpy_is_the_inverse(self):
        cfg = tiny_lm().replace(dtype="bfloat16")
        params = T.init_params(cfg, 3, device=CPU)
        arrays, dtypes = T.params_to_numpy(cfg, params)
        assert dtypes["embed"] == "bfloat16" and \
            dtypes["final_norm"] == "float32"
        assert arrays["embed"].dtype == np.uint16
        back = tree.tree_map(lambda a, d: tree.from_numpy(a, CPU, d),
                             arrays, dtypes)
        assert _bit_equal(back, params)
        # the same bits as ml_dtypes' bfloat16 (what JAX holds)
        np.testing.assert_array_equal(
            arrays["embed"].view(ml_dtypes.bfloat16).astype(np.float32),
            params["embed"].float().numpy())


# ------------------------------------------------------------ fault tolerance
class TestFaultTolerance:
    def _loop(self, tmp_path, injector=None, steps=30, seed=0):
        cfg = tiny_lm()
        params, opt_state = make_state(cfg, seed)
        opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=steps)
        step = jit_train_step(cfg, opt, mesh=None, donate=False)
        batches = iter(SyntheticBatcher(4, 32, cfg.vocab_size, seed=seed))
        mgr = CheckpointManager(tmp_path, keep=3)
        return TrainLoop(step, params, opt_state, batches, mgr,
                         TrainLoopConfig(total_steps=steps,
                                         checkpoint_every=10,
                                         async_checkpoint=False),
                         injector=injector)

    def test_failure_recovery_completes(self, tmp_path):
        inj = FailureInjector({17: "process-death", 23: "device-loss"})
        loop = self._loop(tmp_path / "a", injector=inj)
        summary = loop.run()
        assert summary["final_step"] == 30
        assert summary["restarts"] == 2
        assert np.isfinite(summary["final_loss"])

    def test_restart_equals_uninterrupted_run(self, tmp_path):
        """A run checkpointed at step 10 and restored into a fresh loop
        (other initial weights; its batch iterator advanced to batch 10)
        ends bit-equal to an uninterrupted 20-step run."""
        whole = self._loop(tmp_path / "whole", steps=20)
        whole.run()
        first = self._loop(tmp_path / "split", steps=20)
        first.cfg.total_steps = 10
        first.run()
        second = self._loop(tmp_path / "split", steps=20, seed=5,
                            injector=FailureInjector({0: "process-death"}))
        second.batches = iter(SyntheticBatcher(4, 32, 512, seed=0))
        for _ in range(10):
            next(second.batches)
        summary = second.run()
        assert summary["restarts"] == 1 and summary["final_step"] == 20
        assert [h["loss"] for h in second.history] == \
            [h["loss"] for h in whole.history[10:]]
        assert _bit_equal(second.params, whole.params)
        assert _bit_equal(second.opt_state, whole.opt_state)

    def test_straggler_monitor(self):
        mon = StragglerMonitor(tolerance=2.0, window=10)
        for i in range(10):
            mon.observe(i, 0.1)
        assert mon.observe(10, 0.5) is True
        assert mon.observe(11, 0.11) is False
        assert mon.summary()["mitigated"] == 1

    def test_elastic_plan(self):
        # lose a host: 512 -> 480 chips, model axis 16 stays
        shape, per_shard = elastic_plan(480, (2, 16, 16),
                                        ("pod", "data", "model"), 256)
        assert shape[2] == 16
        assert 256 % per_shard == 0
        assert shape[0] * shape[1] * shape[2] <= 480
        with pytest.raises(ValueError):
            elastic_plan(8, (16, 16), ("data", "model"), 256)

    def test_nan_quarantine(self, tmp_path):
        cfg = tiny_lm()
        params, opt_state = make_state(cfg)

        calls = {"n": 0}

        def poisoned_step(p, o, b):
            calls["n"] += 1
            loss = torch.tensor(np.nan if calls["n"] == 3 else 1.0)
            return p, o, {"loss": loss}

        mgr = CheckpointManager(tmp_path)
        loop = TrainLoop(poisoned_step, params, opt_state,
                         iter(SyntheticBatcher(2, 16, cfg.vocab_size)), mgr,
                         TrainLoopConfig(total_steps=5, checkpoint_every=100,
                                         async_checkpoint=False))
        summary = loop.run()
        assert summary["skipped_nan"] == 1
        assert summary["final_step"] == 5

    def test_nan_quarantine_keeps_the_old_state(self, tmp_path):
        # a real step (donate=False) whose third loss reads NaN: the
        # update it computed is dropped and the fourth step starts from
        # the state the third started from, unchanged
        cfg = tiny_lm()
        params, opt_state = make_state(cfg)
        real = jit_train_step(cfg, AdamW(lr=1e-3, warmup_steps=1),
                              donate=False)
        seen = []

        def step(p, o, b):
            seen.append((p, o, _clone(p), _clone(o)))
            new_p, new_o, m = real(p, o, b)
            if len(seen) == 3:
                m = dict(m, loss=torch.tensor(float("nan")))
            return new_p, new_o, m

        loop = TrainLoop(step, params, opt_state, iter(_batches(4)),
                         CheckpointManager(tmp_path),
                         TrainLoopConfig(total_steps=4, checkpoint_every=100,
                                         async_checkpoint=False))
        assert loop.run()["skipped_nan"] == 1
        p3, o3, p3_copy, o3_copy = seen[2]
        p4, o4, _, _ = seen[3]
        assert p4 is p3 and o4 is o3
        assert _bit_equal(p4, p3_copy) and _bit_equal(o4, o3_copy)


# ------------------------------------------------------------ stream-fed
class TestStreamTraining:
    def test_stream_batcher_feeds_loop(self, tmp_path):
        from repro_torch.streamsim import (Producer, StreamQueue,
                                           VirtualClock, make_stream, nsa,
                                           preprocess)
        cfg = tiny_lm()
        sim = nsa(preprocess(make_stream("traffic", scale=0.01, seed=3)), 60)
        q = StreamQueue(maxsize=64)
        threading.Thread(
            target=Producer(sim, q, clock=VirtualClock()).run,
            daemon=True).start()
        batcher = StreamBatcher(q, batch=2, seq=32, vocab=cfg.vocab_size)
        batches = list(batcher)
        assert len(batches) >= 3
        for b in batches[:3]:
            assert b["inputs"].shape == (2, 32)
            assert b["inputs"].min() >= 1
            assert b["inputs"].max() < cfg.vocab_size
            # labels are inputs shifted by one position
            np.testing.assert_array_equal(b["inputs"][:, 1:],
                                          b["labels"][:, :-1])
        params, opt_state = make_state(cfg)
        loop = TrainLoop(jit_train_step(cfg, AdamW(lr=1e-3), donate=False),
                         params, opt_state, iter(batches), CheckpointManager(
                             tmp_path), TrainLoopConfig(
                             total_steps=3, checkpoint_every=2,
                             async_checkpoint=True))
        summary = loop.run()
        loop.ckpt.wait()
        assert summary["final_step"] == 3 and np.isfinite(
            summary["final_loss"])
        assert loop.ckpt.steps() == [2, 3]


def test_launcher_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` on a stream:
    one injected failure, recovered from the checkpoint before it."""
    from repro_torch.launch import train
    out = train.main([
        "--device", "cpu", "--arch", "llama3-8b", "--dataset", "traffic",
        "--scale", "0.01", "--max-range", "60", "--batch", "2", "--seq",
        "32", "--steps", "8", "--ckpt-every", "3", "--inject-failure", "5",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--out",
        str(tmp_path / "m.json")])
    s = out["summary"]
    assert s["final_step"] == 8 and s["restarts"] == 1
    assert s["stream"]["records_consumed"] > 0
    # steps 3 and 4 run twice: the failure at 5 restores step 3
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 4, 3, 4, 5,
                                                   6, 7]
    assert CheckpointManager(tmp_path / "ckpt").steps() == [6, 8]
