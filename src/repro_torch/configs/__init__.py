"""Assigned architectures × input shapes + the paper's own stream-pipeline
config (copies of the JAX package's ``configs/``, which import no JAX).

Each ``<arch>.py`` exposes ``config()`` (the exact published
hyperparameters) and ``smoke()`` (a reduced same-family config for CPU
tests: float32, tiny dims).

``input_specs(cfg, shape)`` returns meta tensors standing in for every
step input (shapes and dtypes, no allocation): the counterpart of the
reference's ``ShapeDtypeStruct`` stand-ins, which the sharding tables
and the dry-run read.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "recurrentgemma-2b",
    "qwen3-32b",
    "qwen1_5-110b",
    "llama3-8b",
    "command-r-plus-104b",
    "rwkv6-1_6b",
    "deepseek-v3-671b",
    "llama4-scout-17b-a16e",
    "musicgen-medium",
    "llava-next-34b",
]


def _module(arch: str):
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


# --------------------------------------------------------------- the shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic decode (SSM/hybrid); decoder-only archs
    support everything else."""
    if shape == "long_500k":
        return cfg.supports_long_context()
    return True


def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """Meta-tensor stand-ins for the step inputs of one cell, in the
    reference's nesting; the decode cache from ``init_cache(...,
    device="meta")``. ``shape`` names one of :data:`SHAPES` or is a
    :class:`ShapeSpec` of its own (the dry-run's coherence check)."""
    from repro_torch.models import transformer

    spec = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = spec.global_batch, spec.seq_len
    meta = torch.device("meta")
    dt = getattr(torch, cfg.dtype)
    tok = torch.empty((b, s), dtype=torch.int32, device=meta)
    if cfg.input_mode == "embeddings":
        # modality frontend stub: precomputed frame/patch embeddings
        inputs = torch.empty((b, s, cfg.d_model), dtype=dt, device=meta)
    else:
        inputs = tok
    if spec.kind == "train":
        return {"batch": {"inputs": inputs, "labels": tok}}
    if spec.kind == "prefill":
        return {"inputs": inputs,
                "lengths": torch.empty((b,), dtype=torch.int32,
                                       device=meta)}
    # decode: one new token against a seq_len cache
    cache = transformer.init_cache(cfg, b, s, device=meta)
    if cfg.input_mode == "embeddings":
        tokens = torch.empty((b, cfg.d_model), dtype=dt, device=meta)
    else:
        tokens = torch.empty((b,), dtype=torch.int32, device=meta)
    return {"cache": cache, "tokens": tokens}
