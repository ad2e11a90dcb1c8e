"""Transformer assembly for dense GQA models: init, forward, prefill and
decode, driven by :class:`ModelConfig`.

Counterpart of ``repro/models/transformer.py`` for runs of kind
``attn:dense`` (llama3, qwen3, qwen1.5, command-r+, musicgen, llava and
the paper's consumer LM). Parameters keep the reference's pytree: a dict
with ``embed``, ``final_norm``, optional ``lm_head`` and ``runs``, one dict
per run of equal consecutive blocks whose leaves are stacked on a leading
layer axis; the layers of a run are applied in a Python loop (the
reference scans them). :func:`params_from_numpy` carries the reference's
parameters over.

The decode cache is ``{"runs": [{"k", "v"} (R, B, S, Kh, Dh) per run],
"pos": (B,) int32}``. :func:`decode_step` updates it in place and returns
it (the reference returns an updated copy and donates the old one).

Training: :func:`forward` wraps each block in :func:`_remat`
(``cfg.remat``: none, full or dots, as the reference wraps its scan
body), and :func:`lm_loss` takes the next-token cross-entropy chunk by
chunk, so (B, S, V) logits never exist at once. Gradients come from
autograd (:mod:`repro_torch.training.steps`).

Other block kinds (``local`` windows, RG-LRU, RWKV6, MoE, MLA) and the
multi-token-prediction loss raise ``NotImplementedError`` naming the
slice that brings them.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import tree
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
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

#: the slice of the port that brings each block kind not ported yet
_LATER = {
    "local": "recurrentgemma (sliding-window attention)",
    "rglru": "recurrentgemma (RG-LRU)",
    "rwkv": "rwkv6",
    "moe": "MoE (llama4, deepseek)",
}


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


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every block is ``attn:dense``
    (and the model has no MLA and no multi-token-prediction head)."""
    if cfg.mla or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MLA and multi-token prediction come with the "
            "deepseek slice of the port")
    for kind in dict.fromkeys(cfg.blocks()):
        mixer, mlp = kind.split(":")
        for part in (mixer, mlp):
            if part in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} comes with the "
                    f"{_LATER[part]} slice of the port")
        if kind != "attn:dense":
            raise ValueError(f"unknown block kind {kind!r}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ==================================================================== params
def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Dict:
    """Seeded random parameters in the reference's layout, drawn on
    ``device`` (default CUDA) from one :class:`torch.Generator`."""
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
            layer = {"norm1": rmsnorm_init(d, dev),
                     "norm2": rmsnorm_init(d, dev),
                     "mix": attn.attn_init(cfg, gen),
                     "mlp": swiglu_init(gen, d, cfg.d_ff, dt)}
            if stacked is None:       # one allocation per leaf of the run
                stacked = tree.tree_map(lambda t: torch.empty(
                    (count,) + tuple(t.shape), dtype=t.dtype, device=dev),
                    layer)
            tree.tree_map(lambda dst, src, i=i: dst[i].copy_(src), stacked,
                          layer)
        runs.append(stacked)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt),
        "runs": runs,
        "final_norm": rmsnorm_init(d, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dt)
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


# =================================================================== forward
def _layer(stacked: Dict, i: int) -> Dict:
    return tree.tree_map(lambda t: t[i], stacked)


def _embed_inputs(cfg: ModelConfig, params: Dict,
                  inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) through the table, or embeddings (B, S, d) (the
    stub frontends of the audio/vision configs) cast to the model dtype."""
    if inputs.ndim == 2:
        return embed_lookup(params["embed"], inputs)
    return inputs.to(_dtype(cfg))


def _block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, cfg.norm_f32)
    x = x + attn.attention_block(cfg, p["mix"], h, positions)
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps, cfg.norm_f32)
    return x + swiglu(p["mlp"], h2)


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
    (B, S, d), aux losses — empty for dense models). Each block runs
    under :func:`_remat`."""
    check_supported(cfg)
    x = _embed_inputs(cfg, params, inputs)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    body = _remat(cfg, functools.partial(_block_apply, cfg))
    for (kind, count), stacked in zip(_runs(cfg.blocks()), params["runs"]):
        for i in range(count):
            x = body(_layer(stacked, i), x, positions)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32), {}


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
    ``{"ce", "loss"}``). ``aux_weights`` weigh the MoE losses, which come
    with the MoE slice (:func:`check_supported` raises for MoE models)."""
    check_supported(cfg)
    dev = params["embed"].device
    hidden, _ = forward(cfg, params,
                        torch.as_tensor(batch["inputs"], device=dev))
    loss = lm_loss(cfg, params, hidden, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


# ===================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict:
    """Zeroed decode cache on ``device`` (default CUDA), mirroring the run
    structure: per run, k and v of shape (R, B, max_len, Kh, Dh)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    caches = [{"k": torch.zeros((count,) + shape, dtype=dt, device=dev),
               "v": torch.zeros((count,) + shape, dtype=dt, device=dev)}
              for _, count in _runs(cfg.blocks())]
    return {"runs": caches,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _block_decode(cfg: ModelConfig, p: Dict, cache: Dict, i: int,
                  x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Layer ``i`` of a run on one new token; writes its K/V rows into
    ``cache`` (the run's stacked cache) in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, cfg.norm_f32)
    y, _, _ = attn.attn_decode(cfg, p["mix"], h, cache["k"][i],
                               cache["v"][i], pos)
    x = x + y
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps, cfg.norm_f32)
    return x + swiglu(p["mlp"], h2)


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One serving step: tokens (B,) or embeddings (B, d) -> (logits (B, V)
    f32, cache). The cache is updated in place (each sequence's new K/V
    row, then ``pos += 1``) and returned."""
    check_supported(cfg)
    pos = cache["pos"]
    if tokens.ndim == 1:
        x = embed_lookup(params["embed"], tokens[:, None])
    else:
        x = tokens[:, None, :].to(_dtype(cfg))
    for (kind, count), stacked_p, stacked_c in zip(
            _runs(cfg.blocks()), params["runs"], cache["runs"]):
        for i in range(count):
            x = _block_decode(cfg, _layer(stacked_p, i), stacked_c, i, x,
                              pos)
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
    on the inputs' device). The norms of the blocks run in f32 whatever
    ``cfg.norm_f32`` says, as in the reference."""
    check_supported(cfg)
    x = _embed_inputs(cfg, params, inputs)
    b, s_p = x.shape[0], x.shape[1]
    positions = torch.arange(s_p, dtype=torch.int32,
                             device=x.device).expand(b, s_p)
    cache = init_cache(cfg, b, max_len, x.device)
    for (kind, count), stacked_p, stacked_c in zip(
            _runs(cfg.blocks()), params["runs"], cache["runs"]):
        for i in range(count):
            lp = _layer(stacked_p, i)
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            x = x + _attn_prefill(cfg, lp["mix"], h, positions,
                                  stacked_c["k"][i], stacked_c["v"][i])
            h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            x = x + swiglu(lp["mlp"], h2)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    last = torch.clamp(lengths.to(x.device).long() - 1, min=0)
    logits = unembed(x[torch.arange(b, device=x.device), last],
                     _head_table(cfg, params), cfg.logit_softcap)
    cache["pos"].copy_(lengths.to(torch.int32))
    return logits, cache


def _attn_prefill(cfg, p, h, positions, ck, cv) -> torch.Tensor:
    """Full attention over the padded prompts; writes the K/V of every
    position (padding included, as the reference does) into the layer's
    cache ``ck``/``cv`` (B, S_cache, Kh, Dh) in place."""
    q, k, v = attn._qkv(cfg, p, h, positions)
    groups = cfg.n_heads // cfg.n_kv_heads
    out = attn._full_attention(cfg, q, attn._repeat_kv(k, groups),
                               attn._repeat_kv(v, groups), positions, 0)
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
