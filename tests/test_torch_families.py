"""The port's other model families against the JAX package on the CPU:
recurrentgemma (sliding-window attention and RG-LRU), RWKV6, and the
mixtures of experts of llama4-scout and deepseek-v3 (with MLA and the
multi-token-prediction head), at their smoke configs.

Weights come from the JAX package's ``init_params`` and are carried over
with :func:`repro_torch.models.transformer.params_from_numpy`; inputs come
from numpy seeds. Tolerances (all f32): 1e-4 for hidden states and logits,
1e-5 for the units and the loss, 1e-4 normwise for the gradients.

Where the two sides differ on purpose: a ``local`` layer's decode masks
the ring slots not written yet (the reference attends to them until the
ring is full), so the port's decode is held to the reference's decode
once the ring is full and to the reference's teacher-forced forward
before that.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as JT
from repro.models.layers import unembed as j_unembed
from repro_torch import tree
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as TT

CPU = "cpu"
FAMILIES = ["recurrentgemma-2b", "rwkv6-1_6b", "deepseek-v3-671b",
            "llama4-scout-17b-a16e"]


def _t(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0, **replace):
    """(cfg, JAX params, port params) of the same weights."""
    cfg = jconfigs.get_smoke(arch).replace(**replace)
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, TT.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), CPU)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}


@functools.lru_cache(maxsize=None)
def _jit(cfg):
    return (jax.jit(JT.forward, static_argnums=(0,)),
            jax.jit(JT.prefill, static_argnums=(0, 4)),
            jax.jit(JT.decode_step, static_argnums=(0,)))


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_shapes_finite_and_aux(arch):
    """Counterpart of ``TestArchSmoke.test_forward_shapes_finite``: the
    hidden states and the MoE aux losses equal the reference's."""
    cfg, params, tp = _pair(arch)
    toks = _tokens(cfg, 2, 32, 1)
    jh, jaux = _jit(cfg)[0](cfg, params, jnp.asarray(toks))
    th, taux = TT.forward(cfg, tp, _t(toks))
    assert th.shape == (2, 32, cfg.d_model) and torch.isfinite(th).all()
    np.testing.assert_allclose(_f32(th), _f32(jh), rtol=1e-4, atol=1e-4)
    assert set(taux) == set(jaux) == (
        {"moe_lb", "moe_z"} if cfg.n_experts else set())
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch):
    """Ragged prompts (24 positions: recurrentgemma's 16-slot rings are
    full), then two greedy decode steps: logits within 1e-4, positions
    equal, every cache leaf within 1e-5."""
    cfg, params, tp = _pair(arch)
    _, j_prefill, j_decode = _jit(cfg)
    toks = _tokens(cfg, 2, 24, 2)
    lens = np.array([24, 19], np.int32)
    jl, jc = j_prefill(cfg, params, jnp.asarray(toks), jnp.asarray(lens), 32)
    tl, tc = TT.prefill(cfg, tp, _t(toks), _t(lens), max_len=32)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), nxt)
        jl, jc = j_decode(cfg, params, jc, jnp.asarray(nxt))
        tl, tc = TT.decode_step(cfg, tp, tc, _t(nxt))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(_f32(b), _f32(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1_6b",
                                  "llama4-scout-17b-a16e"])
def test_bf16_prefill_and_decode_match_reference(arch):
    """The same in bf16 (the served dtype; the CPU takes the MoE's f32
    gate/up products through f32 operands): logits within 0.1, as the
    dense models' bf16 test. Not deepseek-v3: the reference's bf16 MLA
    decode does not run on the CPU (XLA's CPU dot refuses bf16 x bf16 ->
    f32 there)."""
    cfg, params, tp = _pair(arch, dtype="bfloat16")
    _, j_prefill, j_decode = _jit(cfg)
    toks = _tokens(cfg, 2, 24, 21)
    lens = np.array([24, 20], np.int32)
    jl, jc = j_prefill(cfg, params, jnp.asarray(toks), jnp.asarray(lens), 32)
    tl, tc = TT.prefill(cfg, tp, _t(toks), _t(lens), max_len=32)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0.1, atol=0.1)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = j_decode(cfg, params, jc, jnp.asarray(nxt))
        tl, tc = TT.decode_step(cfg, tp, tc, _t(nxt))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0.1, atol=0.1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
    reference's: the loss and each metric (``moe_lb``, ``moe_z``, ``mtp``
    included) within 1e-5, every gradient leaf within 1e-4 normwise."""
    from repro_torch.training.steps import value_and_grad
    cfg, params, tp = _pair(arch)
    batch = _batch(cfg, seed=3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, p, b), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    (tl, tm), tg = value_and_grad(cfg, tp, batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), tree.leaves(tg)):
        a = np.asarray(a, np.float64)
        err = np.linalg.norm(b.double().numpy() - a)
        assert err <= 1e-4 * max(np.linalg.norm(a), 1e-12), err


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step(arch):
    """Counterpart of ``TestArchSmoke.test_train_step``."""
    from repro_torch.training.optimizer import AdamW, adamw_init
    from repro_torch.training.steps import make_train_step
    cfg = jconfigs.get_smoke(arch)
    params = TT.init_params(cfg, 0, device=CPU)
    step = make_train_step(cfg, AdamW(lr=1e-3, warmup_steps=1))
    p2, o2, metrics = step(params, adamw_init(params), _batch(cfg, s=16))
    assert np.isfinite(float(metrics["loss"])) and int(o2["step"]) == 1
    assert sum(float((a - b).abs().sum()) for a, b in zip(
        tree.leaves(params), tree.leaves(p2))) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_reference_layout(arch):
    """The port's own draw: every leaf's shape and dtype as the
    reference's, so its leaf count is the reference's too."""
    cfg = jconfigs.get_smoke(arch)
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        jax.eval_shape(lambda: JT.init_params(
                            cfg, jax.random.PRNGKey(0))))
    got = tree.tree_map(lambda t: (tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")),
                        TT.init_params(cfg, 4, device=CPU))
    assert got == want


# -------------------------------------------------------------- local rings
def test_local_decode_matches_reference_once_the_ring_is_full():
    """A 24-token prompt fills recurrentgemma's 16-slot rings, and the
    ring wraps again over five decode steps: the port's decode equals the
    reference's decode."""
    cfg, params, tp = _pair("recurrentgemma-2b", seed=5)
    _, j_prefill, j_decode = _jit(cfg)
    toks = _tokens(cfg, 1, 24, 6)
    lens = np.array([24], np.int32)
    jl, jc = j_prefill(cfg, params, jnp.asarray(toks), jnp.asarray(lens), 64)
    tl, tc = TT.prefill(cfg, tp, _t(toks), _t(lens), max_len=64)
    for _ in range(5):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = j_decode(cfg, params, jc, jnp.asarray(nxt))
        tl, tc = TT.decode_step(cfg, tp, tc, _t(nxt))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("max_len", [10, 64])
def test_local_decode_before_the_ring_fills_matches_the_forward(max_len):
    """A 6-token prompt leaves ring slots unwritten: the port's decode
    logits equal the reference's teacher-forced forward over the prompt
    and the generated tokens (where the reference's own decode differs by
    up to 0.65: it attends to the unwritten slots)."""
    cfg, params, tp = _pair("recurrentgemma-2b", seed=7)
    forward, j_prefill, _ = _jit(cfg)
    seq = list(_tokens(cfg, 1, 6, 8)[0])
    tl, tc = TT.prefill(cfg, tp, _t(np.array([seq], np.int32)),
                        _t(np.array([6], np.int32)), max_len=max_len)
    for _ in range(3):
        seq.append(int(torch.argmax(tl[0])))
        tl, tc = TT.decode_step(cfg, tp, tc, _t(np.array(seq[-1:],
                                                         np.int32)))
        jh, _ = forward(cfg, params, jnp.asarray([seq], jnp.int32))
        want = j_unembed(jh[:, -1], JT._head_table(cfg, params),
                         cfg.logit_softcap)
        np.testing.assert_allclose(_f32(tl), _f32(want), rtol=1e-4,
                                   atol=1e-4)


def test_local_window_cache_bounded():
    """Counterpart of the JAX test: a local layer's cache is a ring of
    ``window`` slots whatever ``max_len``; the global ones are not."""
    cfg = jconfigs.get_smoke("recurrentgemma-2b")             # window 16
    cache = TT.init_cache(cfg, 2, 512, CPU)
    kinds = [k for k, _ in TT._runs(cfg.blocks())]
    for kind, run in zip(kinds, cache["runs"]):
        if kind.startswith("local"):
            assert run["k"].shape[2] == run["v"].shape[2] == cfg.window
    assert any(k.startswith("local") for k in kinds)


def test_rwkv_long_decode_state_is_constant_size():
    cfg = jconfigs.get_smoke("rwkv6-1_6b")
    sizes = [sum(t.numel() for t in tree.leaves(TT.init_cache(
        cfg, 2, n, CPU))) for n in (8, 512)]
    assert sizes[0] == sizes[1]


# ------------------------------------------------------------------ RG-LRU
def _rglru_params(seed=0):
    cfg = jconfigs.get_smoke("recurrentgemma-2b")
    p = jrglru.rglru_init(cfg, jax.random.PRNGKey(seed))
    return cfg, p, tree.tree_map(lambda a: _t(np.asarray(a)), dict(p))


@pytest.mark.parametrize("s", [1, 37])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(s, with_h0):
    """The odd/even log-depth scan against ``lax.associative_scan``,
    with and without a carried state (37 recurses through odd and even
    lengths: 37, 18, 9, 4, 2)."""
    cfg, jp, tp = _rglru_params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.lru_width_)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width_)).astype(np.float32) \
        if with_h0 else None
    jh, jlast = jax.jit(jrglru.rglru_scan)(
        jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    th, tlast = trglru.rglru_scan(tp, _t(x), None if h0 is None else _t(h0))
    np.testing.assert_allclose(_f32(th), _f32(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(tlast), _f32(jlast), rtol=1e-5,
                               atol=1e-5)


def test_conv1d_carries_its_state():
    """The conv over a sequence equals the conv over its two halves with
    the first half's state carried, and the reference's."""
    cfg, jp, tp = _rglru_params(1)
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.lru_width_)).astype(np.float32)
    whole, state = trglru._conv1d(tp, _t(x))
    a, st = trglru._conv1d(tp, _t(x[:, :5]))
    b, st2 = trglru._conv1d(tp, _t(x[:, 5:]), st)
    torch.testing.assert_close(torch.cat([a, b], 1), whole, rtol=0, atol=0)
    torch.testing.assert_close(st2, state, rtol=0, atol=0)
    jw, jst = jrglru._conv1d(jp, jnp.asarray(x))
    np.testing.assert_allclose(_f32(whole), _f32(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_f32(state), _f32(jst), rtol=0, atol=0)


def test_rglru_decode_matches_reference():
    cfg, jp, tp = _rglru_params(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((2, cfg.lru_width_)).astype(
        np.float32),
             "conv": rng.standard_normal(
        (2, cfg.conv_width - 1, cfg.lru_width_)).astype(np.float32)}
    jy, js = jrglru.rglru_decode(cfg, jp, jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, state))
    ty, ts = trglru.rglru_decode(cfg, tp, _t(x),
                                 {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-5, atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_f32(ts[k]), _f32(js[k]), rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------------------------- RWKV6
def test_wkv_scan_time_mix_and_channel_mix_carry_their_states():
    """From a non-zero state and previous tokens: the wkv scan, the time
    mix and the channel mix (outputs, last tokens and states) against the
    reference's, and a sequence split in two with the states carried
    equal to the whole."""
    cfg = jconfigs.get_smoke("rwkv6-1_6b")
    jp = jrwkv.rwkv_init(cfg, jax.random.PRNGKey(9))
    tp = tree.tree_map(lambda a: _t(np.asarray(a)), dict(jp))
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    nh = d // hd
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    prev = rng.standard_normal((2, d)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, nh, hd, hd))).astype(np.float32)
    jy, jtok, js = jrwkv.time_mix(cfg, jp, jnp.asarray(x), jnp.asarray(prev),
                                  jnp.asarray(s0))
    ty, ttok, ts = trwkv.time_mix(cfg, tp, _t(x), _t(prev), _t(s0))
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_f32(ttok), _f32(jtok))
    np.testing.assert_allclose(_f32(ts), _f32(js), rtol=1e-5, atol=1e-5)
    y1, tok1, s1 = trwkv.time_mix(cfg, tp, _t(x[:, :4]), _t(prev), _t(s0))
    y2, tok2, s2 = trwkv.time_mix(cfg, tp, _t(x[:, 4:]), tok1, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), ty, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(s2, ts, rtol=1e-6, atol=1e-6)
    jc, jctok = jrwkv.channel_mix(cfg, jp, jnp.asarray(x), jnp.asarray(prev))
    tc, tctok = trwkv.channel_mix(cfg, tp, _t(x), _t(prev))
    np.testing.assert_allclose(_f32(tc), _f32(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_f32(tctok), _f32(jctok))
    r, k, v = (rng.standard_normal((2, 5, nh, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (2, 5, nh, hd)).astype(np.float32)
    jo, jlast = jrwkv._wkv_scan(*map(jnp.asarray, (r, k, v, w)), jp["u"],
                                jnp.asarray(s0), unroll=4)
    to, tlast = trwkv._wkv_scan(*map(_t, (r, k, v, w)), tp["u"], _t(s0))
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(tlast), _f32(jlast), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------- MoE
def test_router_breaks_ties_like_lax_top_k():
    """Exact ties (a row of equal scores among others) pick the lower
    expert ids, as ``lax.top_k`` does (``torch.topk`` need not)."""
    scores = np.array([[0.5, 0.9, 0.9, 0.1, 0.9],
                       [0.3, 0.3, 0.3, 0.3, 0.3],
                       [0.1, 0.2, 0.7, 0.7, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = tmoe.top_k(_t(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the router itself on logits with tied sigmoid scores
    cfg = jconfigs.get_smoke("deepseek-v3-671b").replace(n_experts=5,
                                                         top_k=2)
    p = {"router": np.eye(5, dtype=np.float32)[:, [0, 1, 1, 3, 1]] * 2.0}
    x2 = np.ones((3, 5), np.float32)
    x2[1] = [1, 0, 0, 0, 0]
    _, jids, jaux = jmoe._router(cfg, {"router": jnp.asarray(p["router"])},
                                 jnp.asarray(x2))
    _, tids, taux = tmoe._router(cfg, {"router": _t(p["router"])}, _t(x2))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    for key in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6)


def _ref_slots(ids, e, cap):
    """The reference's slot rule, in numpy: the exclusive cumsum of the
    one-hot assignments, ``cap`` at or past capacity."""
    flat = ids.reshape(-1)
    onehot = np.eye(e, dtype=np.int64)[flat]
    rank = (np.cumsum(onehot, 0) - onehot)[np.arange(flat.size), flat]
    return np.where(rank >= cap, cap, rank)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
def test_moe_capacity_drops_match_reference(arch):
    """``capacity_factor=0.25`` over more than 4096 assignments: the slots
    (drops included) equal the reference's rule exactly, and the block's
    output and aux losses equal the reference's."""
    cfg = jconfigs.get_smoke(arch).replace(capacity_factor=0.25)
    jp = jmoe.moe_init(cfg, jax.random.PRNGKey(12))
    tp = tree.tree_map(lambda a: _t(np.asarray(a)), dict(jp))
    t = (4096 // cfg.top_k // 16 + 1) * 16       # t * k > 4096
    x = np.random.default_rng(13).standard_normal(
        (1, t, cfg.d_model)).astype(np.float32)
    cap = tmoe.capacity(cfg, t)
    assert cap == max(int(t * cfg.top_k / cfg.n_experts * 0.25), 1) < t
    _, ids, _ = tmoe._router(cfg, tp, _t(x[0]))
    slot = tmoe.slots(ids, cfg.n_experts, cap)
    np.testing.assert_array_equal(slot.numpy(), _ref_slots(
        ids.numpy(), cfg.n_experts, cap))
    assert (slot.numpy() == cap).mean() > 0.5      # most assignments drop
    jy, jaux = jax.jit(jmoe.moe_block, static_argnums=0)(
        cfg, jp, jnp.asarray(x))
    ty, taux = tmoe.moe_block(cfg, tp, _t(x))
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-5, atol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-5)


def test_moe_capacity_drops_keep_the_loss_finite():
    """Counterpart of the JAX ``test_moe_capacity_drops_gracefully``, at
    a length where the capacity rule applies (its own 64 tokens route
    dropless): most assignments drop and the loss stays finite."""
    cfg = jconfigs.get_smoke("deepseek-v3-671b").replace(
        capacity_factor=0.25)
    t = (4096 // cfg.top_k // 16 + 1) * 16
    assert tmoe.capacity(cfg, t) < t
    loss, metrics = TT.loss_fn(cfg, TT.init_params(cfg, 14, device=CPU),
                               _batch(cfg, b=1, s=t, seed=14))
    assert np.isfinite(float(loss)) and np.isfinite(float(metrics["mtp"]))


# ---------------------------------------------------------------------- MLA
def test_mla_decode_matches_reference():
    """The absorbed-latent decode over a random cache, positions at the
    cache's start, middle and last slot: output and the updated cache."""
    cfg = jconfigs.get_smoke("deepseek-v3-671b")
    jp = jattn.mla_init(cfg, jax.random.PRNGKey(15))
    tp = tree.tree_map(lambda a: _t(np.asarray(a)), dict(jp))
    rng = np.random.default_rng(16)
    s = 12
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((3, s, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((3, s, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.array([0, 5, s - 1], np.int32)
    jy, jckv, jkr = jax.jit(jattn.mla_decode, static_argnums=0)(
        cfg, jp, *map(jnp.asarray, (x, ckv, kr, pos)))
    tckv, tkr = _t(ckv), _t(kr)
    ty = tattn.mla_decode(cfg, tp, _t(x), tckv, tkr, _t(pos))
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(tckv), _f32(jckv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_f32(tkr), _f32(jkr), rtol=1e-6, atol=1e-6)


def test_mla_block_matches_reference_chunked():
    """The full-sequence MLA through the chunked path (qk dim 24 and v dim
    16 of the smoke config) against the reference's."""
    cfg = jconfigs.get_smoke("deepseek-v3-671b").replace(
        attn_impl="chunked", attn_chunk_q=8, attn_chunk_kv=16)
    jp = jattn.mla_init(cfg, jax.random.PRNGKey(17))
    tp = tree.tree_map(lambda a: _t(np.asarray(a)), dict(jp))
    x = np.random.default_rng(18).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want = jax.jit(jattn.mla_block, static_argnums=0)(
        cfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.mla_block(cfg, tp, _t(x), _t(pos))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_merges_and_resets_every_cache_kind(arch):
    """The engine's ``_merge_cache`` and ``reset`` over ring, MLA and
    recurrent leaves: a sequence batched with others (admitted in two
    prefills, into a slot another sequence held) generates what it
    generates alone, and a reset engine repeats its run."""
    from repro_torch.serving import Request, ServingEngine
    cfg, _, tp = _pair(arch, seed=19)
    rng = np.random.default_rng(20)
    prompt = rng.integers(1, cfg.vocab_size, 7, dtype=np.int32)
    others = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
              for n in (3, 5, 9)]

    def run(eng):
        target = Request(rid=0, prompt=prompt.copy(), max_new_tokens=5)
        reqs = [Request(rid=i + 1, prompt=p.copy(), max_new_tokens=2 + i)
                for i, p in enumerate(others)]
        for r in reqs:
            eng.submit(r)
        eng.tick()
        eng.tick()
        eng.submit(target)
        eng.drain()
        return target.generated, [r.generated for r in reqs]

    solo = ServingEngine(cfg, tp, slots=1, max_len=24, eos_id=-1,
                         device=CPU)
    target = Request(rid=0, prompt=prompt.copy(), max_new_tokens=5)
    solo.submit(target)
    solo.drain()
    eng = ServingEngine(cfg, tp, slots=2, max_len=24, eos_id=-1, device=CPU)
    first, rest = run(eng)
    eng.reset()
    again, rest2 = run(eng)
    assert first == again == target.generated and len(first) == 5
    assert rest == rest2 and eng.metrics.finished == 4
