"""repro_torch — the PyTorch/CUDA port of the IoT stream-simulation
framework ("A Framework for Simulating Real-world Stream Data of the
Internet of Things", Chu, Du, Yu — Journal of Computers, 2022).

Layers, named as in the JAX package ``repro`` they mirror:

- ``repro_torch.streamsim`` : POSD preprocessing, NSA normalize+sample,
  PSDA producer, the sweep plan/engine and the controller.
- ``repro_torch.core``      : public API facade over the pipeline.
- ``repro_torch.kernels``   : hand-written CUDA kernels for Hopper
  (``csrc/*.cu``), each beside its plain PyTorch version.

The package imports ``torch`` and numpy only. Entry points that take a
``device`` run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
