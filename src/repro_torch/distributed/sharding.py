"""Sharding rules: params / batch / cache spec trees per policy, and their
placements on a :class:`~torch.distributed.device_mesh.DeviceMesh`.

Counterpart of ``repro/distributed/sharding.py``, branch for branch.

Mesh axes: ``pod`` (cross-pod DP), ``data`` (DP + FSDP), ``model`` (TP + EP).

Policies
--------
- ``tp``      : tensor-parallel params over 'model'; replicated over data
                (small models — no per-layer FSDP gathers).
- ``fsdp_tp`` : 'tp' + parameters and optimizer state additionally sharded
                over 'data' (ZeRO-3): the steps gather a layer's leaves
                just before the layer and reduce-scatter its gradients.

Rules are *name-based*: each param leaf resolves by its dict key and rank.
Leaves under ``runs`` carry a leading stacked-layer axis (never sharded).
Axes that don't divide the mesh axis size (e.g. kv_heads=8 on model=16)
fall back to replication — the standard GQA-TP compromise.

A spec is a :class:`P`, a tuple with one entry per tensor dim: ``None``,
a mesh axis name, or a tuple of names (the dim sharded over several mesh
axes, major to minor). A mesh is a ``DeviceMesh`` whose dims are named
(sizes from ``mesh_dim_names`` and ``size(i)``) or any object with
``shape`` (a mapping name -> size) and ``axis_names``, as the
reference's tables read them; the tables never touch a device.
:func:`placements` turns a spec into DTensor placements, one per mesh
dim: ``Shard(d)`` where tensor dim ``d`` names the mesh dim, else
``Replicate()``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Any, Dict, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

DP_AXES = ("pod", "data")  # batch shards over both


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names. As JAX's ``PartitionSpec``, a tuple of
    one name is stored as the name and an empty tuple as ``None``, so a
    spec equals the reference's as a tuple."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _mesh_view(mesh) -> Any:
    """``mesh`` as the reference's tables read it: ``shape`` (name -> size)
    and ``axis_names``. ``TypeError`` for anything else."""
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names
        if names is None:
            raise TypeError("a DeviceMesh without mesh_dim_names: name its "
                            "dims ('data', 'model', ...)")
        return SimpleNamespace(
            shape={n: mesh.size(i) for i, n in enumerate(names)},
            axis_names=tuple(names))
    shape, names = getattr(mesh, "shape", None), getattr(mesh, "axis_names",
                                                         None)
    if not isinstance(shape, Mapping) or names is None:
        raise TypeError(f"not a mesh: {type(mesh).__name__} (want a "
                        "DeviceMesh with named dims, or an object with "
                        "shape: name -> size and axis_names)")
    return mesh


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(math.prod(mesh.shape[n] for n in name))
    return mesh.shape[name]


def _dp(mesh):
    return tuple(a for a in DP_AXES if a in mesh.axis_names) or None


def dp_axes(mesh):
    """The mesh's data-parallel axes, major to minor, or ``None``."""
    return _dp(_mesh_view(mesh))


def _fits(dim: int, mesh, axis) -> bool:
    return axis is not None and dim % _axis_size(mesh, axis) == 0


def _maybe(dim: int, mesh, axis):
    return axis if _fits(dim, mesh, axis) else None


# --------------------------------------------------------------- rule table
def _param_spec(cfg, mesh, policy: str, name: str, shape: tuple) -> P:
    """Spec for an *unstacked* param leaf by name/rank."""
    fsdp = ("data" if policy == "fsdp_tp" and "data" in mesh.axis_names
            else None)
    m = "model"

    def f(dim):  # fsdp only if divisible
        return _maybe(dim, mesh, fsdp)

    def t(dim):  # tensor axis only if divisible
        return _maybe(dim, mesh, m)

    r = len(shape)
    if name == "embed":
        # vocab-parallel table; d stays unsharded
        return P(t(shape[0]), None)
    if name == "lm_head":
        # vocab-sharded head
        return P(None, t(shape[1]))
    if name in ("wq",):
        return P(f(shape[0]), t(shape[1]), None)
    if name in ("wk", "wv"):
        return P(f(shape[0]), t(shape[1]), None)
    if name == "wo" and r == 3:
        return P(t(shape[0]), None, f(shape[2]))
    if name in ("gate", "up") and r == 2:       # swiglu
        return P(f(shape[0]), t(shape[1]))
    if name == "down" and r == 2:
        return P(t(shape[0]), f(shape[1]))
    if name in ("gate", "up") and r == 3:       # experts (E, d, f)
        return P(t(shape[0]), f(shape[1]), None)
    if name == "down" and r == 3:               # experts (E, f, d)
        return P(t(shape[0]), None, f(shape[2]))
    if name == "router":
        return P(None, None)
    # --- MLA ---
    if name == "w_dq":
        return P(f(shape[0]), None)
    if name == "w_uq":
        return P(None, t(shape[1]), None)
    if name == "w_dkv":
        return P(f(shape[0]), None)
    if name == "w_ukv":
        return P(None, t(shape[1]), None)
    # --- RG-LRU ---
    if name in ("in_gelu", "in_rnn"):
        return P(f(shape[0]), t(shape[1]))
    if name == "out":
        return P(t(shape[0]), f(shape[1]))
    if name == "conv_w":
        return P(None, t(shape[1]))
    if name in ("conv_b", "lambda"):
        return P(t(shape[0]))
    if name in ("gate_a", "gate_x"):
        return P(None, None, None)
    # --- RWKV ---
    if name in ("wr", "wk_r", "wv_r", "wg", "cm_r"):
        return P(f(shape[0]), t(shape[1]))
    if name == "cm_k":
        return P(f(shape[0]), t(shape[1]))
    if name == "cm_v":
        return P(t(shape[0]), f(shape[1]))
    if name == "w_lora_a":
        return P(f(shape[0]), None)
    if name == "w_lora_b":
        return P(None, f(shape[1]))
    if name == "proj":  # mtp
        return P(f(shape[0]), None)
    if r == 2 and name in ("wo",):              # rwkv wo (d, d)
        return P(t(shape[0]), f(shape[1]))
    # norms, biases, mus, u, small tables -> replicated
    return P(*([None] * r))


def _map_with_path(fn, tree_: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree's leaves, keeping its structure."""
    if isinstance(tree_, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)) and not isinstance(tree_, P):
        return type(tree_)(_map_with_path(fn, v, prefix + (i,))
                           for i, v in enumerate(tree_))
    return fn(prefix, tree_)


def param_pspecs(cfg, mesh, params_shape: Any,
                 policy: str = "fsdp_tp") -> Any:
    """Spec tree matching a params (shape) pytree."""
    mesh = _mesh_view(mesh)

    def walk(path, leaf):
        name = path[-1]
        stacked = "runs" in path
        shape = tuple(leaf.shape)
        # rwkv wk/wv collide with attention names but are rank-2
        if name in ("wk", "wv") and len(shape) - int(stacked) == 2:
            name = name + "_r"
        core = shape[1:] if stacked else shape
        spec = _param_spec(cfg, mesh, policy, name, core)
        if stacked:
            spec = P(None, *spec)
        return spec

    return _map_with_path(walk, params_shape)


# ----------------------------------------------------------------- batches
def batch_pspec(mesh) -> Dict[str, P]:
    dp = _dp(_mesh_view(mesh))
    return {
        "tokens": P(dp, None),
        "embeds": P(dp, None, None),
        "labels": P(dp, None),
        "mask": P(dp, None),
    }


# ------------------------------------------------------------------- cache
def cache_pspecs(cfg, mesh, cache_shape: Any,
                 *, shard_seq: bool = True) -> Any:
    """Decode-cache specs: batch over DP; the long seq axis over 'model';
    recurrent state heads over 'model'."""
    mesh = _mesh_view(mesh)
    dp_all = _dp(mesh)
    m = "model"

    def walk(path, leaf):
        name = path[-1] if path and isinstance(path[-1], str) else None
        shape = tuple(leaf.shape)
        # batch axis shards over DP only when divisible (long_500k has B=1)
        bdim = shape[0] if name == "pos" else (shape[1] if len(shape) > 1
                                               else 1)
        dp = dp_all if (dp_all and bdim % _axis_size(mesh, dp_all) == 0) \
            else None
        if name in ("k", "v"):      # (R, B, S, Kh, Dh)
            seq = _maybe(shape[2], mesh, m) if shard_seq else None
            return P(None, dp, seq, None, None)
        if name in ("ckv", "kr"):   # (R, B, S, X)
            seq = _maybe(shape[2], mesh, m) if shard_seq else None
            return P(None, dp, seq, None)
        if name == "h":             # rglru (R, B, W)
            return P(None, dp, _maybe(shape[2], mesh, m))
        if name == "conv":          # (R, B, K-1, W)
            return P(None, dp, None, _maybe(shape[3], mesh, m))
        if name == "s":             # rwkv (R, B, nh, hd, hd)
            return P(None, dp, _maybe(shape[2], mesh, m), None, None)
        if name in ("tm_prev", "cm_prev"):
            return P(None, dp, None)
        if name == "pos":
            return P(dp)
        return P(*([None] * len(shape)))

    return _map_with_path(walk, cache_shape)


# ------------------------------------------------------- activation rules
def activation_rules(mesh, *, shard_seq: bool = False) -> Dict:
    """Logical-axis rules for :func:`repro_torch.distributed.api.constrain`."""
    dp = _dp(_mesh_view(mesh))
    return {
        "batch": dp,
        "seq": "model" if shard_seq else None,
        "embed": None,
        "heads": "model",
        "kv": None,
        "ff": "model",
        "expert": "model",
        "cap": None,
        "vocab": "model",
        "kvseq": "model",
    }


RULESETS = {
    "tp": dict(policy="tp"),
    "fsdp_tp": dict(policy="fsdp_tp"),
}


# ------------------------------------------------------------- placements
def placements(mesh: DeviceMesh, spec) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a mesh
    dim named by tensor dim ``d`` gets ``Shard(d)``, one named by none
    ``Replicate()``. A dim naming several mesh dims is sharded over them
    major to minor, as JAX does, which DTensor expresses when their order
    is the mesh's."""
    names = tuple(_mesh_view(mesh).axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        for n in group:
            if n not in names:
                raise ValueError(f"spec {spec!r} names {n!r}, not an axis "
                                 f"of the mesh {names}")
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: {group} must follow the "
                             f"mesh's axis order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec!r} uses mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.mesh, self.spec)


def named(mesh: DeviceMesh, specs: Any) -> Any:
    """A tree of :class:`NamedSharding` for a tree of specs."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(named(mesh, v) for v in specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")

