"""Quickstart on the PyTorch port: simulate a real-world IoT stream in 20
lines.

The reference quickstart's pipeline through ``repro_torch.core``: POSD
preprocessing, NSA time-compression (Algorithm 1) on the device's kernels
(B1 and B2 on the card), the volatility report (Tables 1-3 metrics) from
kernel B3, and the PSDA producer (Algorithm 2) feeding a toy consumer.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import threading

from repro_torch.core import (
    Producer,
    StreamQueue,
    VirtualClock,
    make_stream,
    nsa,
    preprocess,
    volatility,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device of the kernels (default: cuda)")
args = ap.parse_args()
on = dict(backend="torch", device=args.device)

# 1) a day of SogouQ-like search-engine queries (synthetic surrogate)
raw = make_stream("sogouq", scale=0.1, seed=0)
stream = preprocess(raw)                     # POSD: parse times, sort, zone
print(f"original: {len(stream):,} records over {stream.time_range/3600:.1f}h "
      f"volatility={volatility(stream, **on)}")

# 2) compress the day into 10 simulated minutes (144x task acceleration)
sim = nsa(stream, max_range=600, **on)       # NSA: normalize + sample
print(f"simulated: {len(sim):,} records into 600s "
      f"volatility={volatility(sim, 600, **on)}")

# 3) replay it through the producer into a consumer (the 'SPS task')
queue = StreamQueue(maxsize=64)
producer = Producer(sim, queue, clock=VirtualClock())
threading.Thread(target=producer.run, daemon=True).start()

seen = 0
for bucket in queue:                         # ordered per-second buckets
    seen += len(bucket)
print(f"consumer received {seen:,} records in "
      f"{producer.emitted_buckets} buckets on {args.device} — "
      f"status={'success' if seen == len(sim) else 'fault'}")
