"""End-to-end run on the PyTorch port: train a ~100M-parameter LM on a
simulated IoT stream.

The reference example's run through ``repro_torch.launch.train``: the
PSDA producer replays one compressed day of UserBehavior, batches inherit
the stream's arrival volatility, a failure is injected two thirds of the
way and the loop recovers from the latest checkpoint. Flags after the
example's own go to the launcher (``--arch llama3-8b`` for its smoke
config, ``--ckpt-dir``, ``--out``).

    PYTHONPATH=src python examples/torch_train_stream.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_stream.py --device cpu

(~100M params; on the CPU a few hundred steps take minutes.)
"""

import argparse

from repro_torch.launch import train

parser = argparse.ArgumentParser()
parser.add_argument("--steps", type=int, default=300)
parser.add_argument("--batch", type=int, default=4)
parser.add_argument("--seq", type=int, default=256)
parser.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
args, rest = parser.parse_known_args()

train.main([
    "--dataset", "userbehavior",
    "--max-range", "600",
    "--scale", "0.05",
    "--steps", str(args.steps),
    "--batch", str(args.batch),
    "--seq", str(args.seq),
    "--ckpt-every", "100",
    "--inject-failure", str(args.steps * 2 // 3),
    "--out", "results/torch_train_stream_metrics.json",
    "--device", args.device,
    *rest,
])
