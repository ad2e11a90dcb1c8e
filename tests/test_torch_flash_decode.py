"""Kernel B8 (GQA decode attention) of the PyTorch port against the JAX
package.

On the CPU the port's wrapper runs its plain version; the JAX side runs
``repro.kernels.ref.flash_decode_ref`` and ``repro.kernels.ops.
flash_decode`` (the Pallas kernel in interpret mode off the TPU). Inputs
come from numpy seeds. Tolerances are the JAX tests' own: 2e-5 in f32,
5e-2 in bf16 (the two sides round the bf16 output from f32 sums taken in
another order).
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_decode import (HEAD_DIMS, MIN_SPLIT_TILES,
                                              flash_decode,
                                              flash_decode_plain,
                                              group_slices, split_size)

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(seed, b, h, kh, d, s, dtype="float32"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, d), (b, s, kh, d), (b, s, kh, d)))
    if dtype == "bfloat16":
        q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    return q, k, v


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _np(t):
    return t.float().numpy()


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# the consumer LM's heads (G = 3, D = 64), llama3-8b's (G = 4, D = 128),
# an MHA row (G = 1), recurrentgemma's (G = 10, D = 256), command-r+'s
# (G = 12, D = 128) and two smoke configs' (D = 16, G = 2 and 4); S not a
# multiple of any block
SHAPES = [(2, 12, 4, 64, 100), (3, 32, 8, 128, 75), (2, 4, 4, 64, 130),
          (2, 10, 1, 256, 70), (2, 24, 2, 128, 50), (3, 8, 4, 16, 40),
          (2, 4, 1, 16, 33)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,d,s", SHAPES)
def test_plain_matches_reference_oracle(b, h, kh, d, s, dtype):
    q, k, v = _inputs(b * s, b, h, kh, d, s, dtype)
    lens = np.array([1, s, s // 3 + 1][:b], np.int32)
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens))
    got = flash_decode_plain(_torch(q), _torch(k), _torch(v),
                             torch.from_numpy(lens))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_pallas_kernel(dtype):
    """The port's ops.flash_decode (CPU: the plain version) against the
    Pallas kernel, which pads S = 200 to its 64-position blocks."""
    b, h, kh, d, s = 3, 12, 4, 64, 200
    q, k, v = _inputs(11, b, h, kh, d, s, dtype)
    lens = np.array([1, 64, 200], np.int32)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), block_s=64)
    got = tops.flash_decode(_torch(q), _torch(k), _torch(v),
                            torch.from_numpy(lens), block_s=64)
    _close(got, want, dtype)


def test_lengths_past_the_cache_mean_the_whole_cache():
    """A length above S (an idle decode slot whose position ran past the
    cache) attends to all S positions, as the reference's mask does."""
    b, h, kh, d, s = 2, 8, 2, 64, 128
    q, k, v = _inputs(5, b, h, kh, d, s)
    lens = np.array([s + 1, 10 * s], np.int32)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), block_s=64)
    got = flash_decode(_torch(q), _torch(k), _torch(v),
                       torch.from_numpy(lens))
    _close(got, want, "float32")
    full = flash_decode(_torch(q), _torch(k), _torch(v),
                        torch.full((b,), s, dtype=torch.int32))
    assert torch.equal(got, full)


def test_junk_past_the_length_changes_nothing():
    """The counterpart of the JAX test_prefix_only_attention: cache rows
    past a row's length (prefill padding leaves junk there, not zeros)
    never reach the output."""
    b, h, kh, d, s = 2, 4, 2, 64, 256
    q, k, v = _inputs(7, b, h, kh, d, s)
    lens = torch.tensor([100, 40], dtype=torch.int32)
    out1 = flash_decode(_torch(q), _torch(k), _torch(v), lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 100:], k2[1, 40:] = 999.0, -999.0
    v2[0, 100:], v2[1, 40:] = -999.0, 1e30
    out2 = flash_decode(_torch(q), _torch(k2), _torch(v2), lens)
    assert torch.equal(out1, out2)


def test_zero_length_row_gives_zeros():
    q, k, v = _inputs(3, 2, 4, 2, 64, 16)
    out = flash_decode(_torch(q), _torch(k), _torch(v),
                       torch.tensor([0, 5], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out[1]).all()


def test_cpu_tensors_launch_nothing():
    before = flash_decode.launches
    q, k, v = _inputs(1, 1, 4, 2, 64, 8)
    flash_decode(_torch(q), _torch(k), _torch(v),
                 torch.tensor([8], dtype=torch.int32))
    assert flash_decode.launches == before


def test_other_devices_raise():
    # meta tensors take the dry-run's shape rule (tests/test_torch_dryrun.py);
    # a real tensor on a device with no path here raises (a stand-in: this
    # CPU build of PyTorch makes no tensor on another device)
    class Elsewhere:
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_decode(Elsewhere(), None, None, None)


# ------------------------------------------- the kernel's algorithm, on the CPU
# The CUDA kernel cannot run here; its algorithm can. The model below is
# the kernel's order of work: each split of `chunk` positions runs four
# warps over 64-position tiles, each warp an online softmax (m, l, acc)
# over its 16 positions of every tile; the warps merge in order; a row
# whose length needs one split normalises at once, a row with several
# merges the splits' partials in split order and normalises once.
_TILE, _WARPS = 64, 4


def _merge(parts):
    """(m, l, acc) partials merged by their maxima, in the order given."""
    m = np.max([p[0] for p in parts], axis=0)
    ms = np.where(m == -np.inf, np.float32(0), m)
    l = np.zeros_like(parts[0][1])
    acc = np.zeros_like(parts[0][2])
    for pm, pl, pacc in parts:
        e = np.exp(pm - ms)
        l = l + pl * e
        acc = acc + pacc * e[..., None]
    return m, l, acc


def _normalise(l, acc):
    return np.where(l[..., None] > 0, acc / np.where(l > 0, l, 1)[..., None],
                    np.float32(0))


def _split_merge_model(q, k, v, lengths, chunk, always_merge=False):
    """f32 numpy model of B8's split-and-merge; ``always_merge`` sends a
    one-split row through the merge too."""
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qf = q.reshape(B, Kh, G, D).astype(np.float32)
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    out = np.zeros((B, Kh, G, D), np.float32)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        splits = []
        for s0 in range(0, n, chunk):
            s1 = min(s0 + chunk, n)
            warps = []
            for w in range(_WARPS):
                m = np.full((Kh, G), -np.inf, np.float32)
                l = np.zeros((Kh, G), np.float32)
                acc = np.zeros((Kh, G, D), np.float32)
                for t0 in range(s0, s1, _TILE):
                    pos = np.arange(t0 + 16 * w, t0 + 16 * w + 16)
                    valid = pos < s1          # rows past s1: zero-filled
                    rows = np.minimum(pos, S - 1)
                    kk = np.where(valid[:, None, None], k[b, rows], 0)
                    vv = np.where(valid[:, None, None], v[b, rows], 0)
                    s = np.einsum("hgd,jhd->hgj", qf[b],
                                  kk.astype(np.float32)) * scale
                    s = np.where(valid, s, -np.inf).astype(np.float32)
                    m_new = np.maximum(m, s.max(axis=-1))
                    ms = np.where(m_new == -np.inf, np.float32(0), m_new)
                    corr = np.exp(m - ms)
                    p = np.exp(s - ms[..., None])
                    l = l * corr + p.sum(axis=-1)
                    acc = acc * corr[..., None] + np.einsum(
                        "hgj,jhd->hgd", p, vv.astype(np.float32))
                    m = m_new
                warps.append((m, l, acc))
            splits.append(_merge(warps))
        if len(splits) == 1 and not always_merge:
            _, l, acc = splits[0]
        elif splits:
            _, l, acc = _merge(splits)
        else:
            continue                          # length 0: zeros
        out[b] = _normalise(l, acc)
    return out.reshape(B, H, D)


#: lengths 0, 1 and at the split boundaries of every split size below
_MODEL_LENGTHS = [0, 1, 63, 64, 65, 511, 512, 513, 600]


@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("chunk", [64, 128, 512])
def test_split_merge_model_matches_plain_and_reference(chunk, G):
    """The kernel's split-and-merge, modelled in f32, against the plain
    version and the JAX oracle within the f32 tolerance."""
    kh, d, s = 2, 64, 600
    b, h = len(_MODEL_LENGTHS), kh * G
    q, k, v = _inputs(chunk + G, b, h, kh, d, s)
    lens = np.array(_MODEL_LENGTHS, np.int32)
    got = _split_merge_model(q, k, v, lens, chunk)
    plain = flash_decode_plain(_torch(q), _torch(k), _torch(v),
                               torch.from_numpy(lens))
    np.testing.assert_allclose(got, _np(plain), rtol=TOL["float32"],
                               atol=TOL["float32"])
    assert not got[0].any()                   # length 0 gives zeros
    want = np.asarray(jref.flash_decode_ref(
        jnp.asarray(q[1:]), jnp.asarray(k[1:]), jnp.asarray(v[1:]),
        jnp.asarray(lens[1:])))
    np.testing.assert_allclose(got[1:], want, rtol=TOL["float32"],
                               atol=TOL["float32"])


@pytest.mark.parametrize("G", [3, 4])
def test_one_split_skips_the_merge_with_the_same_result(G):
    """A row whose length needs one split writes acc / l at once; sent
    through the merge instead it gives the same bits."""
    kh, d, s, chunk = 4, 64, 512, 512
    lens = np.array([1, 63, 64, 65, 300, 512], np.int32)
    q, k, v = _inputs(G, len(lens), kh * G, kh, d, s)
    direct = _split_merge_model(q, k, v, lens, chunk)
    merged = _split_merge_model(q, k, v, lens, chunk, always_merge=True)
    np.testing.assert_array_equal(direct, merged)


@pytest.mark.parametrize("B,Kh,S,blocks,chunk", [
    (8, 8, 512, 2, 128),      # serve_llama3's decode shape (bf16 D 128)
    (16, 8, 32_768, 2, 16_384),   # decode_32k (batch 16): 256 blocks
    (8, 4, 64, 2, 64),        # the consumer LM's serve shape
    (1, 1, 100, 2, 128),      # one sequence, one head: two tiles a split
    (8, 16, 4096, 2, 2048),   # command-r+ (G 12 in two slices), 4096 long
])
def test_split_size_at_the_main_path_shapes(B, Kh, S, blocks, chunk):
    """The split follows from the shapes, the SM count (132, an H100
    SXM's), the blocks an SM holds of the instance and the kernel's
    64-position stage alone: the most splits whose grid fits one wave,
    each of at least two tiles."""
    assert split_size(B, Kh, S, 132, _TILE, blocks) == chunk
    assert chunk % _TILE == 0
    assert chunk >= min(MIN_SPLIT_TILES * _TILE, -(-S // _TILE) * _TILE)


@pytest.mark.parametrize("B,Kh,S,chunk", [
    (8, 1, 2048, 256),        # recurrentgemma's local layers, ring full
    (8, 1, 512, 128),         # the same at phase 17's max_len
    (1, 1, 2048, 128),        # one sequence: 16 splits x 2 group slices
])
def test_split_size_at_recurrentgemmas_decode_shape(B, Kh, S, chunk):
    """recurrentgemma's 10 query heads over one KV head run as two group
    slices of 5, so the grid counts two blocks per KV head and split; the
    bf16 D = 256 instance's 198 KB ring leaves one block an SM, so a wave
    is 132 blocks."""
    n, size = group_slices(10, 8)
    assert (n, size) == (2, 5)
    assert split_size(B, Kh * n, S, 132, _TILE, 1) == chunk
    assert B * Kh * n * -(-S // chunk) <= 132


@pytest.mark.parametrize("G,want", [(1, (1, 1)), (4, (1, 4)), (8, (1, 8)),
                                    (10, (2, 5)), (12, (2, 6)),
                                    (17, (3, 6)), (96, (12, 8))])
def test_group_slices_cover_the_group(G, want):
    """The fewest slices of at most 8 query rows, equal but the last, and
    none empty."""
    n, size = group_slices(G, 8)
    assert (n, size) == want
    assert size <= 8 and (n - 1) * size < G <= n * size


def test_every_config_head_shape_is_built():
    """Each (dtype, head_dim) a config in ``configs/`` reaches has a kernel
    instance (the smoke configs run in f32 and, in one test, in bf16)."""
    from repro_torch import configs
    for arch in configs.ARCH_IDS:
        for cfg in (configs.get_config(arch), configs.get_smoke(arch)):
            if cfg.mla or not any(k.split(":")[0] in ("attn", "local")
                                  for k in cfg.blocks()):
                continue
            assert cfg.head_dim_ in HEAD_DIMS[getattr(torch, cfg.dtype)]
            assert cfg.head_dim_ in HEAD_DIMS[torch.bfloat16]
    from repro_torch.configs.paper_stream import consumer_lm
    assert consumer_lm().head_dim_ in HEAD_DIMS[torch.float32]


@pytest.mark.parametrize("junk_k,junk_v", [
    (999.0, -999.0), (np.nan, np.inf), (np.inf, np.nan)])
def test_split_merge_model_ignores_junk_past_the_length(junk_k, junk_v):
    """Whatever bits lie past a row's length, NaN and inf included, the
    kernel's order of work (zero-filled rows past the length, their scores
    -inf) gives the same bits as with clean rows there."""
    b, h, kh, d, s, chunk = 4, 8, 2, 64, 200, 64
    q, k, v = _inputs(13, b, h, kh, d, s)
    lens = np.array([0, 70, 128, 199], np.int32)
    clean = _split_merge_model(q, k, v, lens, chunk)
    k2, v2 = k.copy(), v.copy()
    for i, n in enumerate(lens.tolist()):
        k2[i, n:], v2[i, n:] = junk_k, junk_v
    np.testing.assert_array_equal(
        _split_merge_model(q, k2, v2, lens, chunk), clean)
