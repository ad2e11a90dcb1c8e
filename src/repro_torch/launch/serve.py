"""Serving driver: batched inference under simulated IoT stream load.

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device``. Request arrivals follow the time-compressed real-world
stream (volatility and trend preserved), so a short load test exercises a
whole day's arrival pattern. The model runs from seeded random weights:
the paper's consumer LM by default, the smoke config of ``--arch``
otherwise. On the card (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset sogouq \\
        --max-range 120 --scale 0.01 --slots 8

and on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_smoke
from repro_torch.configs.paper_stream import consumer_lm
from repro_torch.models import transformer
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.load import stream_arrivals
from repro_torch.streamsim import (
    Producer,
    StreamQueue,
    VirtualClock,
    make_stream,
    nsa,
    preprocess,
)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the load test; prints and writes (``--out``) and returns the
    summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--dataset", default="sogouq",
                    choices=["sogouq", "traffic", "userbehavior"])
    ap.add_argument("--max-range", type=int, default=120)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-requests-per-bucket", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default="results/serve_metrics.json")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.arch else consumer_lm()
    if cfg.input_mode != "tokens":
        raise SystemExit("serve driver demos token archs; embedding-input "
                         "archs are exercised via the dry-run")
    params = transformer.init_params(cfg, args.seed, device=args.device)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, device=args.device)

    raw = make_stream(args.dataset, scale=args.scale, seed=args.seed)
    stream = nsa(preprocess(raw), args.max_range)
    queue = StreamQueue(maxsize=64)
    producer = Producer(stream, queue, clock=VirtualClock())
    thread = threading.Thread(target=producer.run, daemon=True)
    thread.start()

    arrivals = 0
    last_ss = 0
    for ss, reqs in stream_arrivals(
            queue, cfg.vocab_size, prompt_len=args.prompt_len,
            max_new_tokens=args.new_tokens,
            max_requests_per_bucket=args.max_requests_per_bucket):
        last_ss = ss
        for r in reqs:
            engine.submit(r)
            arrivals += 1
        # one simulated second = a few decode ticks (the engine keeps
        # batching) on the producer's virtual clock, which reads ss + 1 at
        # the bucket's emission
        for i in range(4):
            engine.tick(now=float(ss) + 1.0 + i * 0.25)
    engine.drain(now=float(last_ss) + 2.0, tick_s=0.25)
    thread.join()

    summary = {"arrivals": arrivals, **engine.metrics.summary()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
