"""The port's dense GQA models against the JAX package on the CPU.

Weights come from the JAX package's ``init_params`` and are carried over
with :func:`repro_torch.models.transformer.params_from_numpy`; tokens come
from numpy seeds. Tolerances: 1e-6 for the layers, 1e-4 for f32 logits
(the same f32 arithmetic in another summation order), and 0.1 absolute on
bf16 logits of unit scale (the two sides round activations to bf16 at the
same places, but their f32 sums differ in order, and B8 keeps the softmax
weights in f32 where the reference rounds them to bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.paper_stream import consumer_lm as j_consumer_lm
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs.paper_stream import consumer_lm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import transformer as TT

CPU = "cpu"


def _t(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def tiny_consumer():
    """The consumer LM's shape at test size: G = 3 as in consumer_lm()."""
    return consumer_lm().replace(n_layers=2, d_model=96, n_heads=6,
                                 n_kv_heads=2, head_dim=16, d_ff=128,
                                 vocab_size=512, loss_chunk=16)


def _jit(cfg):
    """The reference's prefill and decode_step, jitted (one compile per
    shape instead of op-by-op dispatch)."""
    return (jax.jit(JT.prefill, static_argnums=(0, 4)),
            jax.jit(JT.decode_step, static_argnums=(0,)))


def _pair(cfg, seed=0):
    """(JAX params, port params) of the same weights."""
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    return params, TT.params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                          params), CPU)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_copies(arch):
    for get in ("get_config", "get_smoke"):
        a = dataclasses.asdict(getattr(jconfigs, get)(arch))
        b = dataclasses.asdict(getattr(tconfigs, get)(arch))
        assert a == b
    assert dataclasses.asdict(j_consumer_lm()) == dataclasses.asdict(
        consumer_lm())
    assert {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}


# ------------------------------------------------------------------- layers
class TestLayers:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal(16)).astype(np.float32)

    @pytest.mark.parametrize("f32", [True, False])
    @pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
    def test_rmsnorm(self, f32, dtype):
        x = self.x.astype(dtype)
        want = jL.rmsnorm(jnp.asarray(x), jnp.asarray(self.w), 1e-6, f32)
        got = tL.rmsnorm(_t(x), _t(self.w), 1e-6, f32)
        assert got.dtype == _t(x).dtype
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)

    @pytest.mark.parametrize("theta", [1e4, 5e5])
    def test_rope(self, theta):
        pos = np.array([[0, 1, 2, 7, 31], [3, 4, 5, 6, 63]], np.int32)
        np.testing.assert_allclose(_f32(tL.rope_freqs(16, theta)),
                                   _f32(jL.rope_freqs(16, theta)),
                                   rtol=1e-6)
        want = jL.apply_rope(jnp.asarray(self.x), jnp.asarray(pos), theta)
        got = tL.apply_rope(_t(self.x), _t(pos), theta)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)

    def test_swiglu_matmul(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 16)).astype(np.float32)
        p = {k: (rng.standard_normal(s) / 4).astype(np.float32)
             for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                          ("down", (24, 16)))}
        want = jL.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
        got = tL.swiglu({k: _t(v) for k, v in p.items()}, _t(x))
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)

    @pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
    def test_embed_and_unembed(self, dtype):
        """embed scales by sqrt(d) rounded to the table's dtype; unembed
        returns f32 logits from bf16 operands."""
        rng = np.random.default_rng(2)
        table = rng.standard_normal((50, 24)).astype(dtype)
        toks = np.array([[0, 3, 49], [7, 7, 1]], np.int32)
        want = jL.embed_lookup(jnp.asarray(table), jnp.asarray(toks))
        got = tL.embed_lookup(_t(table), _t(toks))
        assert got.dtype == _t(table).dtype
        np.testing.assert_array_equal(_f32(got), _f32(want))
        x = rng.standard_normal((2, 24)).astype(dtype)
        for cap in (0.0, 30.0):
            want = jL.unembed(jnp.asarray(x), jnp.asarray(table), cap)
            got = tL.unembed(_t(x), _t(table), cap)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                       atol=1e-6)


def test_chunked_attention_matches_reference():
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 64, 4, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    for window in (0, 20):
        want = jattn._chunked_attention(*map(jnp.asarray, (q, k, v, pos)),
                                        window, 16, 32)
        got = tattn._chunked_attention(*map(_t, (q, k, v, pos)), window, 16,
                                       32)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)
        naive = tattn._naive_attention(*map(_t, (q, k, v, pos)), window)
        np.testing.assert_allclose(_f32(got), _f32(naive), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_cache_positions_match_reference(window):
    pos = np.array([0, 3, 4, 9, 17], np.int32)
    want = jattn._cache_positions(jnp.asarray(pos), 6, window)
    got = tattn._cache_positions(_t(pos), 6, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ models
def _models():
    return {"llama3-8b": jconfigs.get_smoke("llama3-8b"),
            "consumer": tiny_consumer(),
            "qwen3-32b": jconfigs.get_smoke("qwen3-32b"),
            "qwen1_5-110b": jconfigs.get_smoke("qwen1_5-110b")}


@pytest.mark.parametrize("name", ["llama3-8b", "consumer"])
def test_prefill_and_decode_match_reference(name):
    """Ragged prompts, then greedy decode steps past max_len: the slot
    whose position reaches the end of the cache keeps decoding over the
    whole cache with its writes dropped, as in the reference."""
    cfg = _models()[name]
    params, tp = _pair(cfg)
    j_prefill, j_decode = _jit(cfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (3, 7)).astype(np.int32)
    lens = np.array([7, 4, 1], np.int32)
    jl, jc = j_prefill(cfg, params, jnp.asarray(toks), jnp.asarray(lens), 10)
    tl, tc = TT.prefill(cfg, tp, _t(toks), _t(lens), max_len=10)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    for _ in range(5):                          # slot 0 reaches pos 11
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), nxt)
        jl, jc = j_decode(cfg, params, jc, jnp.asarray(nxt))
        tl, tc = TT.decode_step(cfg, tp, tc, _t(nxt))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(
            jc["pos"]))
        for jr, tr in zip(jc["runs"], tc["runs"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(_f32(tr[key]), _f32(jr[key]),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["qwen3-32b", "qwen1_5-110b"])
def test_forward_matches_reference(name):
    """qk-norm (qwen3) and qkv-bias (qwen1.5) variants of the block."""
    cfg = _models()[name]
    params, tp = _pair(cfg)
    if cfg.qkv_bias:      # the reference initialises biases to zero
        rng = np.random.default_rng(5)
        for key in ("bq", "bk", "bv"):
            b = rng.standard_normal(params["runs"][0]["mix"][key].shape)
            params["runs"][0]["mix"][key] = jnp.asarray(b, jnp.float32)
            tp["runs"][0]["mix"][key] = _t(b.astype(np.float32))
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 9))
    want, _ = JT.forward(cfg, params, jnp.asarray(toks, jnp.int32))
    got, aux = TT.forward(cfg, tp, _t(toks.astype(np.int32)))
    assert aux == {}
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_embedding_inputs_match_reference():
    """The stub frontends (musicgen, llava) feed (B, S, d) embeddings."""
    cfg = jconfigs.get_smoke("musicgen-medium")
    params, tp = _pair(cfg)
    x = np.random.default_rng(7).standard_normal((2, 6, cfg.d_model))
    x = x.astype(np.float32)
    want, _ = JT.forward(cfg, params, jnp.asarray(x))
    got, _ = TT.forward(cfg, tp, _t(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)
    jl, jc = JT.prefill(cfg, params, jnp.asarray(x), jnp.full((2,), 6),
                        max_len=8)
    tl, tc = TT.prefill(cfg, tp, _t(x), torch.full((2,), 6), max_len=8)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    jl, _ = JT.decode_step(cfg, params, jc, jnp.asarray(x[:, 0]))
    tl, _ = TT.decode_step(cfg, tp, tc, _t(x[:, 0]))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)


def test_idle_slot_past_max_len_leaves_the_cache():
    """A slot at pos >= max_len (the engine decodes idle slots too): its
    cache rows stay as they were, and its logits equal the reference's."""
    cfg = tiny_consumer()
    params, tp = _pair(cfg, seed=2)
    jc = JT.init_cache(cfg, 2, 6)
    rng = np.random.default_rng(8)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32))
        if a.ndim > 1 else a, jc)
    jc["pos"] = jnp.asarray([6, 9], jnp.int32)
    tc = jax.tree.map(lambda a: _t(np.asarray(a)), jc)
    before = [{k: v.clone() for k, v in r.items()} for r in tc["runs"]]
    toks = np.array([5, 17], np.int32)
    jl, jc2 = JT.decode_step(cfg, params, jc, jnp.asarray(toks))
    tl, tc2 = TT.decode_step(cfg, tp, tc, _t(toks))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    for b, r, jr in zip(before, tc2["runs"], jc2["runs"]):
        for key in ("k", "v"):
            assert torch.equal(r[key], b[key])
            np.testing.assert_array_equal(_f32(r[key]), _f32(jr[key]))
    np.testing.assert_array_equal(tc2["pos"].numpy(), [7, 10])


def test_bf16_decode_matches_reference():
    cfg = jconfigs.get_smoke("llama3-8b").replace(dtype="bfloat16")
    params, tp = _pair(cfg, seed=3)
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(9).integers(1, cfg.vocab_size, (2, 6))
    toks = toks.astype(np.int32)
    lens = np.array([6, 3], np.int32)
    j_prefill, j_decode = _jit(cfg)
    jl, jc = j_prefill(cfg, params, jnp.asarray(toks), jnp.asarray(lens), 12)
    tl, tc = TT.prefill(cfg, tp, _t(toks), _t(lens), max_len=12)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0.1, atol=0.1)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jc = j_decode(cfg, params, jc, jnp.asarray(nxt))
        tl, tc = TT.decode_step(cfg, tp, tc, _t(nxt))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0.1, atol=0.1)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)


def test_decode_matches_teacher_forced_forward():
    """Counterpart of the JAX test_decode_matches_forward, on the port
    alone: prefill then one greedy decode step agree with forward over
    the extended sequence."""
    cfg = tconfigs.get_smoke("llama3-8b")
    tp = TT.init_params(cfg, 1, device=CPU)
    b, s = 2, 24
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    hidden, _ = TT.forward(cfg, tp, toks)
    full = tL.unembed(hidden, TT._head_table(cfg, tp))
    pre, cache = TT.prefill(cfg, tp, toks, torch.full((b,), s), max_len=s + 4)
    torch.testing.assert_close(pre, full[:, -1], rtol=2e-3, atol=2e-3)
    nxt = torch.argmax(pre, -1).to(torch.int32)
    dec, cache = TT.decode_step(cfg, tp, cache, nxt)
    hidden2, _ = TT.forward(cfg, tp, torch.cat([toks, nxt[:, None]], 1))
    full2 = tL.unembed(hidden2[:, -1], TT._head_table(cfg, tp))
    torch.testing.assert_close(dec, full2, rtol=2e-3, atol=2e-3)


def test_init_params_is_seeded_on_the_device():
    cfg = tconfigs.get_smoke("llama3-8b")
    a, b = (TT.init_params(cfg, 5, device=CPU) for _ in range(2))
    c = TT.init_params(cfg, 6, device=CPU)
    assert torch.equal(a["runs"][0]["mix"]["wq"], b["runs"][0]["mix"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    shapes = jax.tree.map(lambda x: tuple(x.shape), JT.init_params(
        cfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), a) == shapes


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1_6b",
                                  "deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
def test_unported_block_kinds_raise(arch):
    cfg = tconfigs.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="slice"):
        TT.init_params(cfg, 0, device=CPU)
    with pytest.raises(NotImplementedError, match="slice"):
        TT.init_cache(cfg, 1, 8, CPU)
    with pytest.raises(NotImplementedError, match="slice"):
        TT.loss_fn(cfg, {}, _batch(cfg))


# ------------------------------------------------------------------ training
DENSE_ARCHS = ["llama3-8b", "qwen3-32b", "qwen1_5-110b", "command-r-plus-104b",
               "musicgen-medium", "llava-next-34b"]


def _batch(cfg, b=2, s=32, seed=0):
    """Numpy inputs (tokens, or embeddings for the stub frontends) and
    labels, from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step(arch):
    """Counterpart of the JAX ``TestArchSmoke.test_train_step``."""
    from repro_torch.training.optimizer import AdamW, adamw_init
    from repro_torch.training.steps import make_train_step
    cfg = tconfigs.get_smoke(arch)
    params = TT.init_params(cfg, 0, device=CPU)
    opt_state = adamw_init(params)
    step = make_train_step(cfg, AdamW(lr=1e-3, warmup_steps=1))
    p2, o2, metrics = step(params, opt_state, _batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert int(o2["step"]) == 1
    # params must actually change
    delta = sum(float((a - b).abs().sum()) for a, b in zip(
        tree.leaves(params), tree.leaves(p2)))
    assert delta > 0


def _loss_and_grads(cfg, params, batch):
    from repro_torch.training.steps import value_and_grad
    (loss, _), grads = value_and_grad(cfg, params, batch)
    return float(loss), tree.leaves(grads)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_does_not_change_loss(remat):
    """Counterpart of the JAX test, for both remat policies: the loss and
    every gradient equal those of ``remat="none"`` (tolerances of the
    reference's test)."""
    cfg = tconfigs.get_smoke("llama3-8b").replace(remat="none")
    params = TT.init_params(cfg, 7, device=CPU)
    batch = _batch(cfg, seed=8)
    l1, g1 = _loss_and_grads(cfg, params, batch)
    l2, g2 = _loss_and_grads(cfg.replace(remat=remat), params, batch)
    assert np.isclose(l1, l2, rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_dots_policy_saves_only_the_weight_products():
    """Under ``remat="dots"`` the block's recomputation in the backward
    pass runs no ``aten.mm`` (their outputs were saved) but recomputes
    the rest (the attention's ``bmm`` among it); under ``"full"`` it runs
    the ``mm`` again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    def backward_ops(remat):
        cfg = tconfigs.get_smoke("llama3-8b").replace(remat=remat)
        params = TT.init_params(cfg, 7, device=CPU)
        x = torch.randn(2, 16, cfg.d_model, requires_grad=True)
        pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
        body = TT._remat(cfg, lambda h: TT._block_apply(
            cfg, TT._layer(params["runs"][0], 0), h, pos))
        y = body(x).sum()
        with Count() as c:
            y.backward()
        return c.ops

    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    none, full, dots = (backward_ops(r) for r in ("none", "full", "dots"))
    # "full" runs the forward's products again before the backward's own
    assert full.count(mm) > none.count(mm) == dots.count(mm)
    assert dots.count(bmm) > none.count(bmm)


def test_loss_chunking_invariant():
    cfg = tconfigs.get_smoke("qwen3-32b").replace(loss_chunk=8)
    params = TT.init_params(cfg, 9, device=CPU)
    batch = _batch(cfg, seed=10)
    l1, _ = TT.loss_fn(cfg, params, batch)
    l2, _ = TT.loss_fn(cfg.replace(loss_chunk=32), params, batch)
    assert np.isclose(float(l1), float(l2), rtol=1e-6)


def test_lm_loss_rejects_a_ragged_chunk():
    cfg = tconfigs.get_smoke("llama3-8b").replace(loss_chunk=12)
    params = TT.init_params(cfg, 0, device=CPU)
    with pytest.raises(AssertionError):
        TT.loss_fn(cfg, params, _batch(cfg, s=32))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(remat):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    reference's on the llama3 smoke config, with a mask: loss within 1e-5
    relative, each gradient leaf within 1e-4 relative (and 1e-4 of the
    leaf's largest magnitude absolute)."""
    from repro_torch.training.steps import value_and_grad
    cfg = jconfigs.get_smoke("llama3-8b").replace(remat=remat)
    params, tp = _pair(cfg, seed=11)
    batch = _batch(cfg, seed=12)
    batch["mask"] = (np.random.default_rng(13).random((2, 32)) > 0.2
                     ).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    (tl, tm), tg = value_and_grad(cfg, tp, batch)
    assert set(tm) == set(jm) == {"ce", "loss"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a, np.float64)
        np.testing.assert_allclose(b.double().numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())
