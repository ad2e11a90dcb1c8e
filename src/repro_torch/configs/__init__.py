"""Assigned architectures × input shapes + the paper's own stream-pipeline
config (copies of the JAX package's ``configs/``, which import no JAX).

Each ``<arch>.py`` exposes ``config()`` (the exact published
hyperparameters) and ``smoke()`` (a reduced same-family config for CPU
tests: float32, tiny dims).

The JAX package's ``input_specs`` (``ShapeDtypeStruct`` stand-ins for the
dry-run) waits for the port of ``launch/dryrun.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

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
