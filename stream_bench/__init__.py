"""The benchmark of the stream simulator's PyTorch and CUDA port: one cell
a configuration (recorded streams, entry, knobs, limits) and a traffic mix
(compressed ranges), run by ``stream_bench/run.py``."""
