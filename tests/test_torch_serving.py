"""The port's serving stack against the JAX package on the CPU: the
continuous-batching engine, stream-driven arrivals, ``ServingTask`` under
the replay engine, and the serve CLI.

Both engines run the same weights (carried over with ``params_from_numpy``)
on the same requests; every count and every greedy id must be equal.
Prompts hash string columns with ``hash()``, which is salted per process,
so both sides tokenize in this one process. Nothing is asserted about the
wall-clock latency bins beyond their number.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_stream import consumer_lm
from repro.models import transformer as JT
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.load import stream_arrivals as j_arrivals
from repro.streamsim import Producer as JProducer
from repro.streamsim import ServingTask as JServingTask
from repro.streamsim import StreamQueue as JQueue
from repro.streamsim import VirtualClock as JClock
from repro.streamsim import make_stream as j_make_stream
from repro.streamsim import nsa as j_nsa
from repro.streamsim import preprocess as j_preprocess
from repro.streamsim.engine import replay_many as j_replay_many
from repro_torch.models import transformer as TT
from repro_torch.serving import Request, ServingEngine, stream_arrivals
from repro_torch.streamsim import (Producer, ServingTask, StreamQueue,
                                   VirtualClock, make_stream, nsa,
                                   preprocess)
from repro_torch.streamsim.engine import replay_many

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def tiny_cfg():
    """The JAX serving tests' model: the consumer LM cut to two narrow
    layers."""
    return consumer_lm().replace(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, head_dim=16, d_ff=128,
                                 vocab_size=512, loss_chunk=16)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = TT.params_from_numpy(cfg, jax.tree.map(np.asarray, params), CPU)
    return cfg, params, tp


def _requests(cls, seed, n, max_new):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 512, 3 + i % 4,
                                           dtype=np.int32),
                max_new_tokens=max_new) for i in range(n)]


def _sim(pkg, dataset, scale, seed, max_range):
    make, prep, sample = ((j_make_stream, j_preprocess, j_nsa) if pkg == "jax"
                          else (make_stream, preprocess, nsa))
    return sample(prep(make(dataset, scale=scale, seed=seed)), max_range)


class TestEngine:
    @pytest.mark.parametrize("slots,eos", [(3, -1), (4, 7)])
    def test_same_ids_and_metrics_as_reference(self, setup, slots, eos):
        cfg, params, tp = setup
        j = JEngine(cfg, params, slots=slots, max_len=24, eos_id=eos)
        t = ServingEngine(cfg, tp, slots=slots, max_len=24, eos_id=eos,
                          device=CPU)
        jreqs = _requests(JRequest, slots, 9, 6)
        treqs = _requests(Request, slots, 9, 6)
        for jr, tr in zip(jreqs, treqs):
            j.submit(jr)
            t.submit(tr)
        j.drain(now=0.0, tick_s=1.0)
        t.drain(now=0.0, tick_s=1.0)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
        for key in ("finished", "tokens_out", "decode_steps", "queue_peak",
                    "p50_latency_s", "p99_latency_s"):
            assert t.metrics.summary()[key] == j.metrics.summary()[key], key
        assert t.metrics.finished == 9

    def test_continuous_batching_keeps_a_sequence(self, setup):
        cfg, _, tp = setup
        prompt = np.random.default_rng(2).integers(1, 512, 8, dtype=np.int32)
        alone = ServingEngine(cfg, tp, slots=1, max_len=48, eos_id=-1,
                              device=CPU)
        ref = Request(rid=0, prompt=prompt.copy(), max_new_tokens=6)
        alone.submit(ref)
        alone.drain()
        eng = ServingEngine(cfg, tp, slots=4, max_len=48, eos_id=-1,
                            device=CPU)
        target = Request(rid=0, prompt=prompt.copy(), max_new_tokens=6)
        eng.submit(target)
        for r in _requests(Request, 3, 3, 6):
            eng.submit(r)
        eng.drain()
        assert target.generated == ref.generated
        assert len(ref.generated) == 6

    def test_params_on_another_device_raise(self, setup):
        cfg, _, tp = setup
        with pytest.raises(ValueError, match="params lie on"):
            ServingEngine(cfg, {**tp, "embed": tp["embed"].to("meta")},
                          device=CPU)


def _arrivals(pkg, sim, **kw):
    queue_cls, producer_cls, clock_cls, fn = (
        (JQueue, JProducer, JClock, j_arrivals) if pkg == "jax"
        else (StreamQueue, Producer, VirtualClock, stream_arrivals))
    q = queue_cls(maxsize=64)
    th = threading.Thread(target=producer_cls(sim, q, clock=clock_cls()).run,
                          daemon=True)
    th.start()
    out = [(ss, [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrive_t)
                 for r in reqs]) for ss, reqs in fn(q, 512, **kw)]
    th.join(timeout=60)
    assert not th.is_alive()
    return out


def test_stream_arrivals_match_reference():
    kw = dict(prompt_len=5, max_new_tokens=3, max_requests_per_bucket=3)
    for dataset in ("sogouq", "userbehavior"):
        want = _arrivals("jax", _sim("jax", dataset, 0.003, 4, 30), **kw)
        got = _arrivals("torch", _sim("torch", dataset, 0.003, 4, 30), **kw)
        assert got == want and len(got) > 5


class TestServingTask:
    KW = dict(slots=4, max_len=48, prompt_len=4, max_new_tokens=3,
              max_requests_per_bucket=2)
    KEYS = ("task", "task_buckets", "task_records", "serving_finished",
            "serving_tokens_out", "serving_queue_peak")

    def test_replay_many_matches_reference(self, setup):
        cfg, params, tp = setup
        jsim = _sim("jax", "sogouq", 0.005, 4, 30)
        tsim = _sim("torch", "sogouq", 0.005, 4, 30)
        want, _ = j_replay_many({("sogouq", 30): jsim},
                                JServingTask(cfg, params, **self.KW), 64)
        got, _ = replay_many({("sogouq", 30): tsim},
                             ServingTask(cfg, tp, device=CPU, **self.KW), 64)
        w, g = want[("sogouq", 30)], got[("sogouq", 30)]
        for key in self.KEYS:
            assert g[key] == w[key], key
        np.testing.assert_array_equal(g["task_output_counts"],
                                      w["task_output_counts"])
        assert g["serving_finished"] == g["task_records"] > 5
        assert len(g["task_latency_bins"]) == g["task_records"]
        assert g["task_latency_bins"].dtype == np.int32
        assert g["serving_decode_steps"] > 0

    def test_reuse_engine_resets_state(self, setup):
        cfg, _, tp = setup
        sim = _sim("torch", "sogouq", 0.003, 5, 20)
        task = ServingTask(cfg, tp, device=CPU, reuse_engine=True,
                           **dict(self.KW, slots=2, max_new_tokens=2,
                                  max_requests_per_bucket=1))
        cache = task._engine.cache["runs"][0]["k"]
        runs = [replay_many({("s", 20): sim}, task, 64)[0][("s", 20)]
                for _ in range(2)]
        assert task._engine.cache["runs"][0]["k"] is cache   # in place
        for key in self.KEYS:
            assert runs[0][key] == runs[1][key], key
        np.testing.assert_array_equal(runs[0]["task_output_counts"],
                                      runs[1]["task_output_counts"])


def test_serve_cli_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu --arch llama3-8b``
    serves every arrival of the stream with the smoke config, the arrivals
    being the reference's."""
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    args = ["--dataset", "traffic", "--max-range", "20", "--scale", "0.002",
            "--seed", "3", "--new-tokens", "4"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "llama3-8b", "--out", str(out), *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(out.read_text())
    assert json.loads(proc.stdout) == summary
    want = _arrivals("jax", _sim("jax", "traffic", 0.002, 3, 20),
                     prompt_len=8, max_new_tokens=4,
                     max_requests_per_bucket=4)
    assert summary["arrivals"] == sum(len(r) for _, r in want) > 0
    assert summary["finished"] == summary["arrivals"]
    assert summary["decode_steps"] > 0


def test_serve_cli_needs_cuda_by_default(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--arch", "llama3-8b"])
