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
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_plain)

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


# the consumer LM's heads (G = 3, D = 64), llama3-8b's (G = 4, D = 128)
# and an MHA row (G = 1); S not a multiple of any block
SHAPES = [(2, 12, 4, 64, 100), (3, 32, 8, 128, 75), (2, 4, 4, 64, 130)]


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
    q = torch.zeros((1, 4, 64), device="meta")
    k = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_decode(q, k, k, torch.zeros(1, dtype=torch.int32,
                                          device="meta"))
