"""Transformer assembly for every assigned architecture: init, forward,
loss, prefill and decode, driven by :class:`ModelConfig`.

Counterpart of ``repro/models/transformer.py``. A block is
``<mixer>:<mlp>``: the mixer is global attention (``attn``: GQA, or MLA
when ``cfg.mla``), sliding-window attention (``local``), RG-LRU
(``rglru``) or RWKV6's time mix (``rwkv``, whose channel mix takes the MLP
slot); the MLP is a SwiGLU (``dense``) or a mixture of experts (``moe``).
Parameters keep the reference's pytree: a dict with ``embed``,
``final_norm``, optional ``lm_head`` and ``mtp`` (DeepSeek's
multi-token-prediction head) and ``runs``, one dict per run of equal
consecutive blocks whose leaves are stacked on a leading layer axis; the
layers of a run are applied in a Python loop (the reference scans them).
:func:`params_from_numpy` carries the reference's parameters over.

The decode cache mirrors the runs: ``{"runs": [...], "pos": (B,)
int32}`` with, per run, ``k``/``v`` (R, B, S, Kh, Dh) for GQA (``S =
min(max_len, window)`` for a ``local`` ring), ``ckv`` (R, B, S, R_kv) and
``kr`` (R, B, S, rope) for MLA, ``h``/``conv`` for RG-LRU and
``s``/``tm_prev``/``cm_prev`` for RWKV6, the last two O(1) in the
context. :func:`decode_step` updates it in place and returns it (the
reference returns an updated copy and donates the old one).

Training: :func:`forward` wraps each block in :func:`_remat`
(``cfg.remat``: none, full or dots, as the reference wraps its scan
body) and sums the MoE aux losses over the layers; :func:`loss_fn` adds
them weighted by ``aux_weights`` over the MoE layer count, and 0.3 times
the multi-token-prediction loss. :func:`lm_loss` takes the next-token
cross-entropy chunk by chunk, so (B, S, V) logits never exist at once.
Gradients come from autograd (:mod:`repro_torch.training.steps`).

Distribution: the reference's ``constrain`` calls stand at its points
(the identity on plain tensors). Parameters and caches may be DTensors
(the sharded steps of :mod:`repro_torch.training.steps`): the leaves
outside ``runs`` are gathered once per call, each layer's leaves just
before the layer (inside :func:`_remat`, so the backward pass gathers
them again), and :func:`decode_step` gathers a layer's cache for this
rank's rows and writes its slice back
(:mod:`repro_torch.distributed.layout`). The kernels see plain tensors
only. :func:`param_specs` gives the parameters' shapes and dtypes on the
meta device.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import tree
from repro_torch.distributed import layout
from repro_torch.distributed.api import constrain
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    embed_lookup,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed,
)


# ================================================================= structure
def _runs(blocks: List[str]) -> List[Tuple[str, int]]:
    """Group consecutive equal block kinds: ['a','a','b'] -> [('a',2),('b',1)]."""
    out: List[Tuple[str, int]] = []
    for b in blocks:
        if out and out[-1][0] == b:
            out[-1] = (b, out[-1][1] + 1)
        else:
            out.append((b, 1))
    return out


_MIXERS = ("attn", "local", "rglru", "rwkv")
_MLPS = ("dense", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind the model zoo does not know."""
    for kind in dict.fromkeys(cfg.blocks()):
        mixer, mlp = kind.split(":")
        if mixer not in _MIXERS or mlp not in _MLPS:
            raise ValueError(f"unknown block kind {kind!r}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ==================================================================== params
def _block_init(cfg: ModelConfig, kind: str, gen: torch.Generator) -> Dict:
    mixer, mlp = kind.split(":")
    d, dev = cfg.d_model, gen.device
    p: Dict[str, Any] = {"norm1": rmsnorm_init(d, dev),
                         "norm2": rmsnorm_init(d, dev)}
    if mixer in ("attn", "local"):
        p["mix"] = (attn.mla_init(cfg, gen) if cfg.mla
                    else attn.attn_init(cfg, gen))
    elif mixer == "rglru":
        p["mix"] = rglru_mod.rglru_init(cfg, gen)
    else:                                   # rwkv: holds its channel mix
        p["mix"] = rwkv_mod.rwkv_init(cfg, gen)
    if mixer != "rwkv":
        p["mlp"] = (moe_mod.moe_init(cfg, gen) if mlp == "moe" else
                    swiglu_init(gen, d, cfg.d_ff, _dtype(cfg)))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Dict:
    """Seeded random parameters in the reference's layout, drawn on
    ``device`` (default CUDA) from one :class:`torch.Generator`. A run's
    layers are drawn one at a time into its stacked leaves, so the peak is
    the parameters plus one layer."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = _dtype(cfg)
    d = cfg.d_model
    runs = []
    for kind, count in _runs(cfg.blocks()):
        stacked = None
        for i in range(count):
            layer = _block_init(cfg, kind, gen)
            if stacked is None:       # one allocation per leaf of the run
                stacked = tree.tree_map(lambda t: torch.empty(
                    (count,) + tuple(t.shape), dtype=t.dtype, device=dev),
                    layer)
            tree.tree_map(lambda dst, src, i=i: dst[i].copy_(src), stacked,
                          layer)
            del layer
        runs.append(stacked)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt),
        "runs": runs,
        "final_norm": rmsnorm_init(d, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dt)
    if cfg.mtp:
        p["mtp"] = {"proj": dense_init(gen, 2 * d, d, dt),
                    "block": _block_init(cfg, "attn:dense", gen),
                    "norm": rmsnorm_init(d, dev)}
    return p


def params_from_numpy(cfg: ModelConfig, tree_np, device=None) -> Dict:
    """The reference's parameter pytree, given as numpy arrays (for
    example ``jax.tree.map(np.asarray, params)``), as the port's parameters
    on ``device`` (default CUDA). bfloat16 leaves (``ml_dtypes``' type,
    which ``torch.from_numpy`` refuses) are carried bit for bit through
    their 16-bit pattern."""
    check_supported(cfg)
    dev = resolve_device(device)
    return tree.tree_map(lambda a: tree.from_numpy(a, dev), tree_np)


def opt_state_from_numpy(cfg: ModelConfig, state, device=None) -> Dict:
    """The reference's AdamW state ``{"step", "m", "v"}``, given as numpy
    arrays, as the port's on ``device`` (default CUDA): ``step`` a 0-dim
    int32 tensor, the moments float32 trees of the parameters' layout."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"step": tree.from_numpy(state["step"], dev).to(torch.int32),
            "m": tree.tree_map(lambda a: tree.from_numpy(a, dev),
                               state["m"]),
            "v": tree.tree_map(lambda a: tree.from_numpy(a, dev),
                               state["v"])}


def params_to_numpy(cfg: ModelConfig, params: Dict):
    """The reverse of :func:`params_from_numpy`: ``(arrays, dtypes)``, the
    parameters as host numpy arrays (bfloat16 leaves as their 16-bit
    patterns, ``uint16``) and a tree of their dtype names
    (:func:`repro_torch.tree.tree_to_numpy`)."""
    check_supported(cfg)
    return tree.tree_to_numpy(params)


class _OnMeta(TorchFunctionMode):
    """Every tensor a call makes lands on the meta device: its shape and
    dtype, no storage and no random draw."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def param_specs(cfg: ModelConfig, key=None):
    """The parameter pytree of :func:`init_params` as meta tensors (shapes
    and dtypes, no allocation, no draw), for the sharding tables; ``key``
    is ignored, as the reference's. One layer of each run is built and
    its leaves stacked."""
    check_supported(cfg)
    with _OnMeta():
        gen = torch.Generator()                    # never draws: meta
        runs = [tree.tree_map(lambda t, n=count: t.new_empty(
            (n,) + tuple(t.shape)), _block_init(cfg, kind, gen))
            for kind, count in _runs(cfg.blocks())]
        p = init_params(cfg.replace(n_layers=0), 0, device="cpu")
    p["runs"] = runs
    return p


# =================================================================== forward
def _layer(stacked: Dict, i: int) -> Dict:
    return tree.tree_map(lambda t: t[i], stacked)


def _gather_top(params: Dict) -> Dict:
    """``params`` with every leaf outside ``runs`` (the embedding, the
    head, the final norm, the MTP head) gathered whole where it is a
    DTensor (:func:`repro_torch.distributed.layout.gather`); the runs'
    layers are gathered one at a time in the layer loops."""
    return {k: v if k == "runs" else layout.gather(v)
            for k, v in params.items()}


def _embed_inputs(cfg: ModelConfig, params: Dict,
                  inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) through the table, or embeddings (B, S, d) (the
    stub frontends of the audio/vision configs) cast to the model dtype."""
    if inputs.ndim == 2:
        return embed_lookup(params["embed"], inputs)
    return inputs.to(_dtype(cfg))


def _block_apply(cfg: ModelConfig, kind: str, p: Dict, x: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One block over a sequence: (x, aux losses of its MoE, else {}).
    DTensor leaves of ``p`` are gathered here, inside :func:`_remat`, so
    the backward pass gathers them again instead of keeping them."""
    mixer, mlp = kind.split(":")
    aux: Dict[str, torch.Tensor] = {}
    p = layout.gather(p)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, cfg.norm_f32)
    if mixer == "attn":
        y = (attn.mla_block(cfg, p["mix"], h, positions) if cfg.mla
             else attn.attention_block(cfg, p["mix"], h, positions))
    elif mixer == "local":
        y = attn.attention_block(cfg, p["mix"], h, positions,
                                 window=cfg.window)
    elif mixer == "rglru":
        y = rglru_mod.rglru_block(cfg, p["mix"], h)
    else:
        y = rwkv_mod.rwkv_block(cfg, p["mix"], h)
    x = x + y
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps, cfg.norm_f32)
    if mixer == "rwkv":
        prev = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                           device=x.device)
        y2, _ = rwkv_mod.channel_mix(cfg, p["mix"], h2, prev)
    elif mlp == "moe":
        y2, aux = moe_mod.moe_block(cfg, p["mlp"], h2)
    else:
        y2 = swiglu(p["mlp"], h2)
    x = x + y2
    x = constrain(x, "batch", "seq", "embed")
    return x, aux


#: the weight products of a block and of the logits head: ``matmul`` of
#: an activation (B, S, d) by a 2-D weight runs as ``aten.mm`` (the
#: attention's score and value products, which have a batch axis, run as
#: ``aten.bmm``). Under ``remat="dots"`` their outputs are saved and
#: everything else is recomputed, the counterpart of the reference's
#: ``dots_with_no_batch_dims_saveable``.
_DOTS_SAVED = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: ``"none"`` keeps every activation for
    the backward pass, ``"full"`` keeps only ``fn``'s inputs and runs it
    again in the backward pass, ``"dots"`` also keeps the outputs of the
    weight products (:data:`_DOTS_SAVED`)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        # the contexts are made anew for every call (``context_fn``)
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)  # "full"


def forward(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """inputs: (B, S) tokens or (B, S, d) embeddings. Returns (hidden
    (B, S, d), aux losses: the MoE layers' ``moe_lb`` and ``moe_z`` summed
    over the layers, empty without MoE). Each block runs under
    :func:`_remat`. DTensor parameters are gathered a layer at a time."""
    check_supported(cfg)
    params = _gather_top(params)
    x = _embed_inputs(cfg, params, inputs)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    x = constrain(x, "batch", "seq", "embed")
    aux: Dict[str, torch.Tensor] = {}
    for (kind, count), stacked in zip(_runs(cfg.blocks()), params["runs"]):
        body = _remat(cfg, functools.partial(_block_apply, cfg, kind))
        run_aux: Dict[str, torch.Tensor] = {}
        for i in range(count):
            x, layer_aux = body(_layer(stacked, i), x, positions)
            for k, v in layer_aux.items():
                run_aux[k] = run_aux[k] + v if k in run_aux else v
        for k, v in run_aux.items():      # the reference sums run by run
            aux[k] = aux[k] + v if k in aux else v
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    return x, aux


def _head_table(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]
    return params["lm_head"].T  # (V, d) view for unembed


# ====================================================================== loss
def lm_loss(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
            labels: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (B, S, V):
    ``cfg.loss_chunk`` positions at a time through the f32 logits head,
    each chunk's body under :func:`_remat` unless ``cfg.remat`` is
    ``"none"``. Returns a 0-dim f32 tensor."""
    b, s, d = hidden.shape
    c = min(cfg.loss_chunk, s)
    assert s % c == 0, (s, c)
    table = _head_table(cfg, params)
    labels = torch.as_tensor(labels, device=hidden.device).long()
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    mask = torch.as_tensor(mask, device=hidden.device).float()

    def chunk(h, y, m):
        logits = unembed(h, table, cfg.logit_softcap)        # (B, C, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None])[..., 0]
        return ((lse - gold) * m).sum(), m.sum()

    if cfg.remat != "none":
        chunk = _remat(cfg, chunk)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for j in range(0, s, c):
        nll, n = chunk(hidden[:, j:j + c], labels[:, j:j + c],
                       mask[:, j:j + c])
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            aux_weights: Tuple[float, float] = (0.01, 1e-3)
            ) -> Tuple[torch.Tensor, Dict]:
    """batch: ``{"inputs": tokens (B, S) or embeddings (B, S, d),
    "labels": (B, S)}`` and an optional ``"mask"`` (B, S), as tensors or
    numpy arrays (moved to the parameters' device) -> (0-dim loss,
    metrics). Metrics: ``ce`` and ``loss``; with MoE layers ``moe_lb`` and
    ``moe_z`` (per MoE layer, weighted into the loss by ``aux_weights``);
    with an MTP head ``mtp`` (weighted by 0.3)."""
    check_supported(cfg)
    params = _gather_top(params)
    dev = params["embed"].device
    inputs = torch.as_tensor(batch["inputs"], device=dev)
    hidden, aux = forward(cfg, params, inputs)
    loss = lm_loss(cfg, params, hidden, batch["labels"], batch.get("mask"))
    metrics = {"ce": loss}
    if "moe_lb" in aux:
        n_moe = max(sum(1 for k in cfg.blocks() if k.endswith(":moe")), 1)
        lb, z = aux["moe_lb"] / n_moe, aux["moe_z"] / n_moe
        loss = loss + aux_weights[0] * lb + aux_weights[1] * z
        metrics.update(moe_lb=lb, moe_z=z)
    if cfg.mtp:
        mtp_loss = _mtp_loss(cfg, params, hidden, inputs, batch["labels"])
        loss = loss + 0.3 * mtp_loss
        metrics["mtp"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
              tokens: torch.Tensor, labels) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction: one more block predicts token
    t+2 from ``[h_t ; emb(tok_{t+1})]`` at every position but the last
    (masked: it has no t+1 token). 0 for embedding inputs."""
    p = params["mtp"]
    if tokens.ndim != 2:
        return torch.zeros((), dtype=torch.float32, device=hidden.device)
    b, s = tokens.shape
    labels = torch.as_tensor(labels, device=hidden.device)
    emb_next = embed_lookup(params["embed"], torch.cat(
        [tokens[:, 1:], tokens.new_zeros((b, 1))], 1))
    h_in = torch.matmul(torch.cat([hidden, emb_next], -1),
                        p["proj"]).to(hidden.dtype)
    pos = torch.arange(s, dtype=torch.int32,
                       device=hidden.device).expand(b, s)
    h2, _ = _block_apply(cfg, "attn:dense", p["block"], h_in, pos)
    h2 = rmsnorm(h2, p["norm"], cfg.norm_eps)
    labels2 = torch.cat([labels[:, 1:], labels.new_zeros((b, 1))], 1)
    mask = torch.cat([torch.ones((b, s - 1), device=hidden.device),
                      torch.zeros((b, 1), device=hidden.device)], 1)
    return lm_loss(cfg, params, h2, labels2, mask)


# ===================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Zeroed decode cache on ``device`` (default CUDA), mirroring the run
    structure: per run of R layers, k and v (R, B, S, Kh, Dh) with ``S =
    max_len``, or ``min(max_len, window)`` for a ``local`` ring; MLA's
    ``ckv``/``kr``; the O(1) states of RG-LRU and RWKV6. ``device="meta"``
    gives its shapes and dtypes without storage."""
    check_supported(cfg)
    dev = (torch.device("meta") if device is not None and
           torch.device(device).type == "meta" else resolve_device(device))
    dt = _dtype(cfg)

    def stacked(state, count):
        return {k: torch.zeros((count,) + tuple(v.shape), dtype=v.dtype,
                               device=dev) for k, v in state.items()}

    caches = []
    for kind, count in _runs(cfg.blocks()):
        mixer = kind.split(":")[0]
        if mixer in ("attn", "local"):
            s = (min(max_len, cfg.window) if mixer == "local" and cfg.window
                 else max_len)
            if cfg.mla:
                shapes = {"ckv": (batch, s, cfg.kv_lora_rank),
                          "kr": (batch, s, cfg.qk_rope_dim)}
            else:
                kv = (batch, s, cfg.n_kv_heads, cfg.head_dim_)
                shapes = {"k": kv, "v": kv}
            caches.append({k: torch.zeros((count,) + shape, dtype=dt,
                                          device=dev)
                           for k, shape in shapes.items()})
        elif mixer == "rglru":
            caches.append(stacked(rglru_mod.rglru_state_init(
                cfg, batch, dt, dev), count))
        else:
            caches.append(stacked(rwkv_mod.rwkv_state_init(
                cfg, batch, dt, dev), count))
    return {"runs": caches,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _write(cache: Dict, i: int, state: Dict) -> None:
    """Layer ``i``'s leaves of a run's stacked ``cache`` <- ``state``, in
    place."""
    for k, v in state.items():
        cache[k][i].copy_(v)


def _layer_state(cache: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in cache.items()}


def _block_decode(cfg: ModelConfig, kind: str, p: Dict, cache: Dict,
                  i: int, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Layer ``i`` of a run on one new token; writes its cache rows or its
    state into ``cache`` (the run's stacked cache) in place."""
    mixer, mlp = kind.split(":")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, cfg.norm_f32)
    if mixer in ("attn", "local") and cfg.mla:
        y = attn.mla_decode(cfg, p["mix"], h, cache["ckv"][i],
                            cache["kr"][i], pos)
    elif mixer in ("attn", "local"):
        window = cfg.window if mixer == "local" else 0
        y, _, _ = attn.attn_decode(cfg, p["mix"], h, cache["k"][i],
                                   cache["v"][i], pos, window=window)
    elif mixer == "rglru":
        y, state = rglru_mod.rglru_decode(cfg, p["mix"], h,
                                          _layer_state(cache, i))
        _write(cache, i, state)
    else:
        y, state = rwkv_mod.rwkv_decode(cfg, p["mix"], h,
                                        _layer_state(cache, i))
        _write(cache, i, {"s": state["s"], "tm_prev": state["tm_prev"]})
    x = x + y
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps, cfg.norm_f32)
    if mixer == "rwkv":
        y2, cm_prev = rwkv_mod.channel_mix(cfg, p["mix"], h2,
                                           cache["cm_prev"][i])
        cache["cm_prev"][i].copy_(cm_prev)
    elif mlp == "moe":
        y2, _ = moe_mod.moe_block(cfg, p["mlp"], h2)
    else:
        y2 = swiglu(p["mlp"], h2)
    return x + y2


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One serving step: tokens (B,) or embeddings (B, d) -> (logits (B, V)
    f32, cache). The cache is updated in place (each sequence's new cache
    rows and states, then ``pos += 1``) and returned.

    With DTensor parameters and cache (the sharded serve step), ``tokens``
    are this rank's rows and so are the logits: each layer's parameters
    are gathered whole, and its cache over every mesh dim but the batch's
    (:func:`repro_torch.distributed.layout.layer_cache`), then this rank's
    slice of the updated layer is written back."""
    check_supported(cfg)
    params = _gather_top(params)
    pos = layout.local(cache["pos"])
    if tokens.ndim == 1:
        x = embed_lookup(params["embed"], tokens[:, None])
    else:
        x = tokens[:, None, :].to(_dtype(cfg))
    for (kind, count), stacked_p, stacked_c in zip(
            _runs(cfg.blocks()), params["runs"], cache["runs"]):
        sharded = any(layout.is_sharded(t) for t in stacked_c.values())
        for i in range(count):
            lp = layout.gather(_layer(stacked_p, i))
            if sharded:
                lc = layout.layer_cache(stacked_c, i)
                x = _block_decode(cfg, kind, lp, lc, 0, x, pos)
                layout.write_layer_cache(stacked_c, i, lc)
            else:
                x = _block_decode(cfg, kind, lp, stacked_c, i, x, pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    logits = unembed(x[:, 0], _head_table(cfg, params), cfg.logit_softcap)
    pos.add_(1)
    return logits, cache


def prefill(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
            lengths: torch.Tensor, max_len: int
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompts and build their cache. inputs: (B, S_p) tokens
    or (B, S_p, d) embeddings; lengths: (B,) valid prompt lengths. Returns
    (last-position logits (B, V) f32, a new cache of ``max_len`` positions
    on the inputs' device). As in the reference, the norms of the blocks
    run in f32 whatever ``cfg.norm_f32`` says, every position's cache rows
    are written (padding included), and a recurrent state is the one after
    the last padded position. DTensor parameters are gathered a layer at a
    time; the cache is built for the rows of ``inputs``."""
    check_supported(cfg)
    params = _gather_top(params)
    x = _embed_inputs(cfg, params, inputs)
    b, s_p = x.shape[0], x.shape[1]
    positions = torch.arange(s_p, dtype=torch.int32,
                             device=x.device).expand(b, s_p)
    cache = init_cache(cfg, b, max_len, x.device)
    for (kind, count), stacked_p, stacked_c in zip(
            _runs(cfg.blocks()), params["runs"], cache["runs"]):
        mixer = kind.split(":")[0]
        for i in range(count):
            lp = layout.gather(_layer(stacked_p, i))
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            if mixer in ("attn", "local") and cfg.mla:
                y = _mla_prefill(cfg, lp["mix"], h, positions,
                                 stacked_c["ckv"][i], stacked_c["kr"][i])
            elif mixer in ("attn", "local"):
                y = _attn_prefill(cfg, lp["mix"], h, positions,
                                  stacked_c["k"][i], stacked_c["v"][i],
                                  cfg.window if mixer == "local" else 0)
            elif mixer == "rglru":
                y, state = rglru_mod.rglru_prefill(
                    cfg, lp["mix"], h, _layer_state(stacked_c, i))
                _write(stacked_c, i, state)
            else:
                y, tm_prev, s_last = rwkv_mod.time_mix(
                    cfg, lp["mix"], h, stacked_c["tm_prev"][i],
                    stacked_c["s"][i])
                _write(stacked_c, i, {"s": s_last, "tm_prev": tm_prev})
            x = x + y
            h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            if mixer == "rwkv":
                prev = torch.zeros((b, x.shape[-1]), dtype=x.dtype,
                                   device=x.device)
                y2, cm_prev = rwkv_mod.channel_mix(cfg, lp["mix"], h2, prev)
                stacked_c["cm_prev"][i].copy_(cm_prev)
            elif kind.endswith(":moe"):
                y2, _ = moe_mod.moe_block(cfg, lp["mlp"], h2)
            else:
                y2 = swiglu(lp["mlp"], h2)
            x = x + y2
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    last = torch.clamp(lengths.to(x.device).long() - 1, min=0)
    logits = unembed(x[torch.arange(b, device=x.device), last],
                     _head_table(cfg, params), cfg.logit_softcap)
    cache["pos"].copy_(lengths.to(torch.int32))
    return logits, cache


def _attn_prefill(cfg, p, h, positions, ck, cv, window: int) -> torch.Tensor:
    """Causal (``window > 0``: sliding-window) attention over the padded
    prompts; writes the K/V of every position (padding included, as the
    reference does) into the layer's cache ``ck``/``cv`` (B, S_cache, Kh,
    Dh) in place."""
    q, k, v = attn._qkv(cfg, p, h, positions)
    groups = cfg.n_heads // cfg.n_kv_heads
    out = attn._full_attention(cfg, q, attn._repeat_kv(k, groups),
                               attn._repeat_kv(v, groups), positions, window)
    y = attn._out_proj(out, p["wo"], h.dtype)
    s, s_cache = h.shape[1], ck.shape[1]
    if s <= s_cache:
        ck[:, :s] = k
        cv[:, :s] = v
    else:   # the reference keeps the last s_cache positions, rotated so
        # that slot (pos % s_cache) holds position pos
        shift = s % s_cache
        ck.copy_(torch.roll(k[:, -s_cache:], shift, dims=1))
        cv.copy_(torch.roll(v[:, -s_cache:], shift, dims=1))
    return y


def _mla_prefill(cfg, p, h, positions, ckv, kr) -> torch.Tensor:
    """MLA over the padded prompts; writes every position's latent into
    the layer's cache ``ckv``/``kr`` in place."""
    y = attn.mla_block(cfg, p, h, positions)
    c_kv, k_rope = attn.mla_latent(cfg, p, h, positions)
    ckv[:, :h.shape[1]] = c_kv
    kr[:, :h.shape[1]] = k_rope
    return y
