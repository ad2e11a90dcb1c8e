"""Serving substrate: batched prefill/decode engine whose request arrivals
are driven by the simulated IoT stream (the paper's load-testing scenario).
"""

from repro_torch.serving.engine import ServingEngine, Request, ServeMetrics  # noqa: F401
from repro_torch.serving.load import stream_arrivals  # noqa: F401
