"""Hand-written CUDA kernels for Hopper, one per TPU kernel on the path.

- :mod:`repro_torch.kernels.stream_sample` — B1, the fused NSA inner
  loop: rebase -> normalize -> scale stamp -> systematic keep bit.
- :mod:`repro_torch.kernels.compact`       — B2, keep mask -> kept-record
  indices (three-phase scan with the scatter fused in).
- :mod:`repro_torch.kernels.metrics_fused` — B3, per-row int32 histogram of
  scale stamps plus its Kahan-folded moments ``[Σq, Σq²]``; B6, the same
  over one time chunk with the Kahan state carried from chunk to chunk; and
  B3's time form, the same of original streams read as float64 timestamps
  where B1 left them, bucketed in registers.
- :mod:`repro_torch.kernels.trend_scan`    — B4, per-row inclusive int32
  prefix sums of count series (three-phase scan), B7, the same with each
  row's running total carried in and out, and B5, per-row sums and the Gram
  matrix of centered trends (output tiles times time splits in thread
  block clusters, each byte read once, f32, no TF32).
- :mod:`repro_torch.kernels.flash_decode`  — B8, GQA decode attention over
  a KV cache masked by lengths (split-KV flash-decoding, f32 accumulation).

Each module holds the kernel's wrapper (CUDA tensors launch the kernel,
CPU tensors run the plain version; each launch adds one to the wrapper's
``launches`` count) and its plain PyTorch version. :mod:`repro_torch.
kernels.ops` builds the inputs; :mod:`repro_torch.kernels._build` compiles
``csrc/*.cu`` with ``nvcc`` at first use, once per tile instance;
:mod:`repro_torch.kernels.tuning` chooses the instance a dispatch launches
(``autotune``).
"""
