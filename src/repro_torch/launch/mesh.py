"""Mesh construction over the initialized ``torch.distributed`` group.

Counterpart of ``repro/launch/mesh.py``. Functions, not module-level
constants, so importing this module touches no device and no process
group. The caller initializes the group first
(``torch.distributed.init_process_group(backend, init_method=
"tcp://<host>:<port>", world_size=..., rank=...)``: nothing here learns a
cluster by itself). Axes: 'pod' (cross-pod DP), 'data' (DP + FSDP),
'model' (TP + EP + seq-sharded decode).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# NVIDIA H100 SXM, one card (NVIDIA's data sheet: dense rates, 700 W)
PEAK_FLOPS_BF16 = 989e12      # per card
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per card, each way
HBM_PER_CHIP = 80 * 10**9     # 80 GB
#: cards joined by NVLink in one node (a DGX H100 / HGX H100 8-GPU board)
CARDS_PER_NODE = 8
#: bytes/s per card between nodes: one 400 Gb/s NDR InfiniBand port a GPU
#: (the DGX H100 system's eight ConnectX-7 compute ports, NVIDIA's DGX H100
#: data sheet); a collective whose group spans nodes moves at this rate
IB_BW = 50e9

#: world sizes of the production meshes: (16, 16) and (2, 16, 16)
PRODUCTION_SHAPES = {256: ((16, 16), ("data", "model")),
                     512: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device) -> str:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA mesh was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' for a gloo mesh on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {dev}")
    return dev.type


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``, over a
    world of exactly 256 or 512 ranks (the dry-run's fake world, or a real
    one). ``device=None`` means CUDA (which raises without it); tests pass
    ``"cpu"``."""
    want = 512 if multi_pod else 256
    shape, axes = PRODUCTION_SHAPES[want]
    world = _world()
    if world != want:
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{want} ranks, this one has {world}")
    return DeviceMesh(_device_type(device),
                      torch.arange(want).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """Small ``("data", "model")`` mesh over ranks 0 … data·model−1 of the
    initialized group — tests and examples. ``device=None`` means CUDA
    (which raises without it); tests pass ``"cpu"`` (a gloo group)."""
    dev = _device_type(device)
    n = _world()
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the group has {n}")
    return DeviceMesh(dev, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))
