"""Hand-written CUDA kernels for Hopper, one per TPU kernel on the path.

- :mod:`repro_torch.kernels.stream_sample` — B1, the fused NSA inner
  loop: normalize -> scale stamp -> systematic keep bit.
- :mod:`repro_torch.kernels.compact`       — B2, keep mask -> kept-record
  indices (three-phase scan with the scatter fused in).
- :mod:`repro_torch.kernels.metrics_fused` — B3, per-row int32 histogram of
  scale stamps plus its Kahan-folded moments ``[Σq, Σq²]``.

Each module holds the kernel's wrapper (CUDA tensors launch the kernel,
CPU tensors run the plain version; each launch adds one to the wrapper's
``launches`` count) and its plain PyTorch version. :mod:`repro_torch.
kernels.ops` builds the inputs; :mod:`repro_torch.kernels._build` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""
