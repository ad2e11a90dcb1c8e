"""repro_torch — the PyTorch/CUDA port of the IoT stream-simulation
framework ("A Framework for Simulating Real-world Stream Data of the
Internet of Things", Chu, Du, Yu — Journal of Computers, 2022).

Layers, named as in the JAX package ``repro`` they mirror:

- ``repro_torch.streamsim`` : POSD preprocessing, NSA normalize+sample,
  PSDA producer, the sweep plan/engine and the controller.
- ``repro_torch.core``      : public API facade over the pipeline.
- ``repro_torch.kernels``   : hand-written CUDA kernels for Hopper
  (``csrc/*.cu``), each beside its plain PyTorch version.
- ``repro_torch.models``, ``configs``, ``serving``, ``training``,
  ``launch`` : the dense GQA consumer LMs (llama3-8b, the paper's consumer
  LM, ...), the continuous-batching serving engine driven by the simulated
  stream (``streamsim.ServingTask``), the stream-fed fault-tolerant
  training loop, and their CLIs (``python -m repro_torch.launch.serve``,
  ``python -m repro_torch.launch.train``).
- ``repro_torch.tree`` : the pytrees (nested dicts and lists of tensors)
  the models and the training stack walk, in JAX's leaf order.

The package imports ``torch`` and numpy only. Entry points that take a
``device`` run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
