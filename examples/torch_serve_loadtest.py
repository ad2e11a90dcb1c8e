"""Serving load test on the PyTorch port, driven by a time-compressed
real-world stream.

The reference example's run through ``repro_torch.launch.serve``: a small
LM serves batched requests whose arrivals follow the compressed SogouQ
query stream (continuous batching, prefill + decode with kernel B8 on the
card, latency percentiles reported). Flags after the example's own go to
the launcher (``--arch llama3-8b`` for its smoke config, ``--out``).

    PYTHONPATH=src python examples/torch_serve_loadtest.py
    PYTHONPATH=src python examples/torch_serve_loadtest.py --device cpu
"""

import argparse

from repro_torch.launch import serve

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
args, rest = parser.parse_known_args()

serve.main([
    "--dataset", "sogouq",
    "--max-range", "60",
    "--scale", "0.01",
    "--slots", "8",
    "--max-len", "48",
    "--prompt-len", "8",
    "--new-tokens", "6",
    "--max-requests-per-bucket", "3",
    "--out", "results/torch_serve_loadtest_metrics.json",
    "--device", args.device,
    *rest,
])
