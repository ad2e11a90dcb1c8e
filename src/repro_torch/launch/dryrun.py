"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake
tensors over a fake process group.

Counterpart of ``repro/launch/dryrun.py``. The reference proves the
distribution config coherent without real hardware by lowering and
compiling each cell's step on 512 host devices. The port proves it by
running the sharded step itself once, as rank 0 of a fake world of 256
ranks (the (16, 16) mesh) or 512 (the (2, 16, 16) mesh): the process
group is ``torch.distributed``'s ``"fake"`` backend, which answers every
collective without sending anything, and every tensor is a
``FakeTensor``, which has a shape, a dtype and a device but no data. Each
input is this rank's local shard, laid out by ``param_pspecs``,
``batch_pspec`` and ``cache_pspecs`` as the step places it. The run
supplies the roofline inputs: :class:`~repro_torch.launch.hlo_analysis.
StepCost` counts FLOPs, bytes and collectives from the ops the rank
dispatches and follows its live memory; ``FlopCounterMode`` counts FLOPs
a second time, on its own.

The roofline is the reference's, at one H100's data-sheet rates
(:mod:`repro_torch.launch.mesh`): FLOPs over the bf16 tensor-core peak,
bytes over HBM's rate, and each collective's bytes over the slowest link
its group crosses (NVLink inside a node of 8 cards, InfiniBand across
nodes). These are analytic bounds, not measurements.

Usage::

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
        --mesh both --device cpu
    python -m repro_torch.launch.dryrun --all --mesh single --device cpu

``--device`` omitted means CUDA (fake CUDA tensors; it raises without
CUDA).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    cell_supported,
    get_config,
    input_specs,
)
from repro_torch.distributed import layout
from repro_torch.distributed.sharding import (
    P,
    cache_pspecs,
    dp_axes,
    named,
    param_pspecs,
)
from repro_torch.launch import mesh as _mesh
from repro_torch.launch.hlo_analysis import analyze_step, flop_counter
from repro_torch.launch.mesh import (
    CARDS_PER_NODE,
    HBM_BW,
    HBM_PER_CHIP,
    IB_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    make_production_mesh,
)
from repro_torch.models import transformer
from repro_torch.training.optimizer import AdamW
from repro_torch.training.steps import (
    _token_spec,
    _train_specs,
    jit_prefill_step,
    jit_serve_step,
    jit_train_step,
)

#: ranks of the fake world each mesh kind runs in
MESH_RANKS = {"single": 256, "multi": 512}


# -------------------------------------------------------------- model flops
def model_flops(cfg, shape_name: str) -> float:
    """6·N_active·D for train; 2·N_active·B (+cache attention) for decode."""
    spec = SHAPES[shape_name]
    n_active = active_params(cfg)
    b, s = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        return 6.0 * n_active * b * s
    attn_per_tok = 0.0
    for kind in cfg.blocks():
        mixer = kind.split(":")[0]
        if mixer in ("attn", "local"):
            ctx = min(s, cfg.window) if (mixer == "local" and cfg.window) else s
            if cfg.mla:
                attn_per_tok += 2 * cfg.n_heads * ctx * (
                    2 * cfg.kv_lora_rank + cfg.qk_rope_dim)
            else:
                attn_per_tok += 4 * cfg.n_heads * cfg.head_dim_ * ctx
    if spec.kind == "prefill":
        # causal triangle: average context s/2
        return 2.0 * n_active * b * s + b * attn_per_tok * s / 2
    return b * (2.0 * n_active + attn_per_tok)


def active_params(cfg) -> float:
    n = cfg.n_params()
    if cfg.n_experts > 0:
        per_expert = 3 * cfg.d_model * cfg.d_ff_expert
        n_moe_layers = sum(1 for k in cfg.blocks() if k.endswith(":moe"))
        inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
        n -= inactive
    return float(n)


# ------------------------------------------------------------- fake world
@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake ``torch.distributed`` world of
    ``n`` ranks (every collective answered, nothing sent); the group is
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run makes its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_inputs(args, specs, mesh):
    """Each meta leaf of ``args`` as a DTensor laid out by the matching
    spec of ``specs``: its local shard an uninitialised tensor on the
    mesh's device (a fake one under ``FakeTensorMode``)."""
    out = []
    for t, sh in zip(tree.leaves(args), tree.leaves(named(mesh, specs)),
                     strict=True):
        loc = layout.own_slice(t, mesh, sh.placements)
        out.append(DTensor.from_local(
            torch.empty(loc.shape, dtype=t.dtype, device=mesh.device_type),
            mesh, sh.placements, run_check=False, shape=t.shape,
            stride=t.stride()))
    return tree.unflatten(args, out)


def build_step(cfg, spec, mesh, shard_seq: bool = False):
    """``(step, args, specs)`` of one cell, built as the reference's
    ``lower_cell`` builds it: the sharded step, its inputs as meta tensors
    of the global shapes and the partition specs the step lays them out
    by (so placing them moves nothing)."""
    ins = input_specs(cfg, spec)
    pshape = transformer.param_specs(cfg)
    if spec.kind == "train":
        step = jit_train_step(cfg, AdamW(), mesh, policy="fsdp_tp",
                              donate=True, shard_seq=shard_seq)
        f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,
                                    device="meta")
        opt = {"step": torch.empty((), dtype=torch.int32, device="meta"),
               "m": tree.tree_map(f32, pshape),
               "v": tree.tree_map(f32, pshape)}
        return step, (pshape, opt, ins["batch"]), _train_specs(
            cfg, mesh, "fsdp_tp")
    pspec = param_pspecs(cfg, mesh, pshape, "tp")
    dp = dp_axes(mesh)
    if spec.kind == "prefill":
        step = jit_prefill_step(cfg, mesh)
        ispec = P(dp, None) if cfg.input_mode == "tokens" else P(
            dp, None, None)
        return step, (pshape, ins["inputs"], ins["lengths"]), (
            pspec, ispec, P(dp))
    step = jit_serve_step(cfg, mesh, batch=spec.global_batch,
                          max_len=spec.seq_len, donate=True)
    rows = dp if spec.global_batch % layout.dp_size(mesh) == 0 else None
    return step, (pshape, ins["cache"], ins["tokens"]), (
        pspec, cache_pspecs(cfg, mesh, ins["cache"]), _token_spec(cfg, rows))


def trace_step(cfg, spec, mesh, shard_seq: bool = False):
    """``(cost, trace_s)``: the cell's step run once on fake local shards
    under ``StepCost`` (:func:`~repro_torch.launch.hlo_analysis.
    analyze_step`) with ``FlopCounterMode`` beneath it; ``cost`` gains
    ``flop_counter_flops``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    step, args, specs = build_step(cfg, spec, mesh, shard_seq)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = shard_inputs(args, specs, mesh)
        counter = flop_counter()
        t0 = time.perf_counter()
        with counter:
            cost, _ = analyze_step(step, *args)
        t_trace = time.perf_counter() - t0
    cost["flop_counter_flops"] = float(counter.get_total_flops())
    return cost, t_trace


# ------------------------------------------------------------------ tracing
def trace_cell(arch: str, shape_name: str, mesh_kind: str,
               overrides: dict | None = None, device=None):
    """The counterpart of the reference's ``lower_cell``: the cell's step
    on the production mesh of the fake world this process is in (see
    :func:`fake_world`), traced once. Returns ``(cfg, mesh, cost,
    trace_s)``."""
    cfg = get_config(arch)
    shard_seq = False
    if overrides:
        overrides = dict(overrides)
        shard_seq = overrides.pop("shard_seq", False)
        if overrides:
            cfg = cfg.replace(**overrides)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=device)
    cost, t_trace = trace_step(cfg, SHAPES[shape_name], mesh, shard_seq)
    return cfg, mesh, cost, t_trace


def link_bw(ranks) -> float:
    """The slowest link a group of ``ranks`` crosses: NVLink inside one
    node of :data:`CARDS_PER_NODE` cards, InfiniBand across nodes."""
    return NVLINK_BW if len({r // CARDS_PER_NODE for r in ranks}) == 1 \
        else IB_BW


def memory_record(mem: dict) -> dict:
    """The reference's memory keys from a step's tracked memory
    (:meth:`~repro_torch.launch.hlo_analysis.StepCost.memory`): temp is
    the peak over the arguments, and the per-device total counts a
    donated argument updated in place once."""
    temp = mem["peak_bytes"] - mem["argument_bytes"]
    per_dev = (mem["argument_bytes"] + mem["output_bytes"] + temp
               - mem["alias_bytes"])
    return {"argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"], "temp_bytes": temp,
            "alias_bytes": mem["alias_bytes"], "per_device_bytes": per_dev,
            "hbm_fraction": per_dev / HBM_PER_CHIP}


def analyze(arch: str, shape_name: str, mesh_kind: str, cfg, mesh, cost,
            t_trace) -> dict:
    """The reference's record of a cell, from a traced step's cost."""
    n_dev = mesh.size()
    flops = float(cost["flops"])
    bytes_accessed = float(cost["bytes"])
    groups = [dict(g, link="nvlink" if link_bw(g["ranks"]) == NVLINK_BW
                   else "ib") for g in cost["collective_groups"]]
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_accessed / HBM_BW
    t_coll = sum(g["bytes"] / link_bw(g["ranks"]) for g in groups)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_name)
    mf_per_dev = mf / n_dev
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": n_dev, "ok": True, "device": mesh.device_type,
        "trace_s": round(t_trace, 2),
        "hlo_flops": flops, "hlo_bytes": bytes_accessed,
        "flop_counter_flops": cost["flop_counter_flops"],
        "collective_bytes_per_device": float(cost["collective_bytes"]),
        "collectives": cost["collectives"],
        "collective_groups": groups,
        "warnings": cost["warnings"],
        "memory": memory_record(cost["memory"]),
        "roofline": {
            **terms,
            "dominant": dominant,
            "step_time_lower_bound_s": max(terms.values()),
            "model_flops": mf,
            "model_flops_per_device": mf_per_dev,
            "useful_flops_ratio": mf_per_dev / flops if flops else 0.0,
            "roofline_fraction": (mf_per_dev / PEAK_FLOPS_BF16)
                                 / max(max(terms.values()), 1e-12),
        },
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, verbose: bool = True,
             device=None) -> dict:
    """One cell in its own fake world (:data:`MESH_RANKS`); a failure is
    recorded as ``ok: False`` with the error, as the reference records
    it."""
    try:
        with fake_world(MESH_RANKS[mesh_kind]):
            out = analyze(arch, shape_name, mesh_kind,
                          *trace_cell(arch, shape_name, mesh_kind, overrides,
                                      device))
    except Exception as e:  # noqa: BLE001 — a failed cell, recorded
        out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    if verbose:
        if out["ok"]:
            r = out["roofline"]
            print(f"[OK] {arch} × {shape_name} × {mesh_kind}: "
                  f"trace={out['trace_s']}s "
                  f"flops={out['hlo_flops']:.3e} "
                  f"mem/dev={out['memory']['per_device_bytes']/2**30:.2f}GiB "
                  f"dominant={r['dominant']} "
                  f"bound={r['step_time_lower_bound_s']:.4f}s", flush=True)
        else:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_kind}: "
                  f"{out['error']}", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf loop)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: cuda)")
    args = ap.parse_args(argv)
    _mesh._device_type(args.device)     # CUDA asked for and absent: raise

    overrides = json.loads(args.override) if args.override else None
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for a in ARCH_IDS:
            cfg = get_config(a)
            for s in SHAPES:
                if cell_supported(cfg, s):
                    cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for a, s in cells:
        for m in meshes:
            fn = outdir / f"{args.tag}__{a}__{s}__{m}.json"
            if not cell_supported(get_config(a), s):
                print(f"[SKIP] {a} × {s}: full-attention arch, long-context "
                      f"cell unsupported (DESIGN.md §Arch-applicability)")
                res = {"arch": a, "shape": s, "mesh": m, "ok": True,
                       "skipped": True,
                       "reason": "full attention: 500k decode needs "
                                 "sub-quadratic mixer"}
                fn.write_text(json.dumps(res, indent=2))
                continue
            res = run_cell(a, s, m, overrides, device=args.device)
            fn.write_text(json.dumps(res, indent=2))
            n_fail += 0 if res["ok"] else 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
