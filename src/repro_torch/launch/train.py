"""Training driver: train an LM on a simulated IoT stream (end-to-end).

Counterpart of ``repro/launch/train.py``: the SPS-as-training-job, POSD ->
NSA -> PSDA producer -> StreamBatcher -> fault-tolerant TrainLoop, with
the same flags plus ``--device``. The model is the paper's ~126M consumer
LM by default (f32, 12 layers, no remat) or the smoke config of
``--arch``, from seeded random weights. NSA runs on the host (numpy), as
in the reference. On the card (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.train --dataset userbehavior \\
        --max-range 600 --steps 200 --inject-failure 120

and on the CPU with ``--device cpu`` (``--dataset synthetic`` skips the
stream).
"""

from __future__ import annotations

import argparse
import json
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.configs.paper_stream import consumer_lm
from repro_torch.models import transformer
from repro_torch.streamsim import (
    Producer,
    StreamQueue,
    VirtualClock,
    make_stream,
    nsa,
    preprocess,
)
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import StreamBatcher, SyntheticBatcher
from repro_torch.training.ft import FailureInjector
from repro_torch.training.optimizer import AdamW, adamw_init
from repro_torch.training.steps import jit_train_step
from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig


def build_batches(args, vocab: int):
    if args.dataset == "synthetic":
        return iter(SyntheticBatcher(args.batch, args.seq, vocab)), None
    raw = make_stream(args.dataset, scale=args.scale, seed=args.seed)
    stream = nsa(preprocess(raw), args.max_range)
    queue = StreamQueue(maxsize=256)
    producer = Producer(stream, queue, clock=VirtualClock())
    th = threading.Thread(target=producer.run, daemon=True)
    th.start()
    batcher = StreamBatcher(queue, args.batch, args.seq, vocab)

    def forever():
        while True:  # re-produce the stream when exhausted (epochs)
            yield from batcher
            q2 = StreamQueue(maxsize=256)
            p2 = Producer(stream, q2, clock=VirtualClock())
            threading.Thread(target=p2.run, daemon=True).start()
            batcher.queue = q2

    return forever(), batcher


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train; prints the summary and writes it with the last 50 steps
    (``--out``). Returns ``{"summary": ..., "history": every step's
    record}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (smoke config); default 100M LM")
    ap.add_argument("--dataset", default="userbehavior",
                    choices=["sogouq", "traffic", "userbehavior", "synthetic"])
    ap.add_argument("--max-range", type=int, default=600)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a crash at this step (recovers from ckpt)")
    ap.add_argument("--out", default="results/train_metrics.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.arch else consumer_lm()
    cfg = cfg.replace(remat="none") if cfg.n_layers <= 12 else cfg
    params = transformer.init_params(cfg, args.seed, device=args.device)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"model={cfg.name} params={n_params/1e6:.1f}M")

    opt = AdamW(lr=args.lr, total_steps=args.steps)
    opt_state = adamw_init(params)
    step_fn = jit_train_step(cfg, opt, mesh=None, donate=False)
    batches, batcher = build_batches(args, cfg.vocab_size)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    injector = None
    if args.inject_failure is not None:
        injector = FailureInjector({args.inject_failure: "process-death"})
    loop = TrainLoop(step_fn, params, opt_state, batches, ckpt,
                     TrainLoopConfig(total_steps=args.steps,
                                     checkpoint_every=args.ckpt_every),
                     injector=injector,
                     on_metrics=lambda s, m: (
                         print(f"step {s}: loss={m['loss']:.4f} "
                               f"wall={m['wall_s']*1e3:.0f}ms")
                         if s % 10 == 0 else None))
    summary = loop.run()
    ckpt.wait()     # the final checkpoint is on disk before main returns
    if batcher is not None:
        summary["stream"] = {
            "buckets_consumed": batcher.buckets_consumed,
            "records_consumed": batcher.records_consumed,
        }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "history": loop.history[-50:]}, f,
                  indent=2)
    print(json.dumps(summary, indent=2))
    return {"summary": summary, "history": loop.history}


if __name__ == "__main__":
    main()
