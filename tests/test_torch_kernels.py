"""The CPU path of the port's K1-K3 wrappers against the Pallas kernels of
csgn_tpu (interpret mode on CPU) and the jnp oracles, bit-exactly.

Shapes follow tests/test_kernels.py.  Words and masks are made by numpy from
fixed seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgn_tpu import layout as jl
from csgn_tpu.ops import core as jcore
from csgn_tpu.ops import kernels as jk
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import core as tcore
from csgn_tpu_torch.ops import dispatch, kernels


def _words(rng, chunks, ctx):
    w = rng.integers(0, 2**32, size=(ctx.words32, chunks), dtype=np.uint32)
    return w & ctx.valid_mask[:, None]


def _mask(rng, ctx):
    return jl.bit_positions_to_mask(rng.choice(ctx.n, ctx.d, replace=False), ctx.n)


@pytest.mark.parametrize("t1,t2", [(1, 1), (2, 3), (8, 16), (13, 7), (9, 33)])
def test_mul_chunks_matches_pallas(ctx, t1, t2):
    rng = np.random.default_rng(t1 * 100 + t2)
    a, b = _words(rng, t1, ctx), _words(rng, t2, ctx)
    want = np.asarray(jk.mul_chunks_pallas(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        want, np.asarray(jcore.mul_chunks(jnp.asarray(a), jnp.asarray(b))))
    got = kernels.mul_chunks(words_from_numpy(a, device="cpu"), words_from_numpy(b, device="cpu"))
    np.testing.assert_array_equal(words_to_numpy(got), want)
    got = dispatch.mul_chunks(words_from_numpy(a, device="cpu"), words_from_numpy(b, device="cpu"))
    np.testing.assert_array_equal(words_to_numpy(got), want)


@pytest.mark.parametrize(
    "t1,t2,fa,fb", [(4, 128, 1, 3), (5, 128, 3, 5), (8, 256, 2, 3), (3, 384, 3, 128)]
)
def test_mul_decrypt_matches_pallas(ctx, t1, t2, fa, fb):
    """Product, parity and raw count, including odd*odd (parity 1) and
    odd*even (parity 0) forced matches."""
    rng = np.random.default_rng(t1 * 1000 + t2)
    mask = _mask(rng, ctx)
    a, b = _words(rng, t1, ctx), _words(rng, t2, ctx)
    a[:, rng.choice(t1, size=fa, replace=False)] |= mask[:, None]
    b[:, rng.choice(t2, size=fb, replace=False)] |= mask[:, None]
    ja, jb, jm = jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)
    want_prod, want_parity = jk.mul_decrypt_pallas(ja, jb, jm)
    _, want_count = jk.mul_decrypt_pallas(ja, jb, jm, return_count=True)

    ta, tb, tm = (words_from_numpy(x, "cpu") for x in (a, b, mask))
    prod, parity = kernels.mul_decrypt(ta, tb, tm)
    _, count = kernels.mul_decrypt(ta, tb, tm, return_count=True)
    np.testing.assert_array_equal(words_to_numpy(prod), np.asarray(want_prod))
    assert int(parity) == int(want_parity)
    assert int(count) == int(want_count) >= fa * fb
    prod2, parity2 = dispatch.mul_decrypt(ta, tb, tm)
    _, count2 = dispatch.mul_decrypt_count(ta, tb, tm)
    assert np.array_equal(words_to_numpy(prod2), words_to_numpy(prod))
    assert (int(parity2), int(count2)) == (int(parity), int(count))


@pytest.mark.parametrize("chunks", [1, 2, 19, 512, 1025])
def test_decrypt_matches_pallas(ctx, chunks):
    rng = np.random.default_rng(chunks)
    mask = _mask(rng, ctx)
    words = _words(rng, chunks, ctx)
    words[:, rng.choice(chunks, size=(chunks + 1) // 2, replace=False)] |= mask[:, None]
    want = int(jk.decrypt_parity_pallas(jnp.asarray(words), jnp.asarray(mask)))
    tw, tm = words_from_numpy(words, device="cpu"), words_from_numpy(mask, device="cpu")
    assert int(kernels.decrypt_parity(tw, tm)) == want
    assert int(dispatch.decrypt_parity(tw, tm)) == want
    want_bits = np.asarray(jcore.chunk_matches(jnp.asarray(words), jnp.asarray(mask)))
    np.testing.assert_array_equal(kernels.chunk_matches(tw, tm).numpy(), want_bits)
    np.testing.assert_array_equal(dispatch.chunk_matches(tw, tm).numpy(), want_bits)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "batched"])
def test_core_oracles_match_jax(small_ctx, lead):
    """The torch oracles on [W, C] and batched [B, W, C] words, against
    csgn_tpu.ops.core."""
    rng = np.random.default_rng(len(lead))
    mask = _mask(rng, small_ctx)
    full = (*lead, small_ctx.words32, 5)
    a = rng.integers(0, 2**32, size=full, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=full, dtype=np.uint32)
    a[..., :2] |= mask[:, None]
    ta, tb, tm = (words_from_numpy(x, "cpu") for x in (a, b, mask))
    ja, jb, jm = jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)
    np.testing.assert_array_equal(words_to_numpy(tcore.add_chunks(ta, tb)),
                                  np.asarray(jcore.add_chunks(ja, jb)))
    np.testing.assert_array_equal(words_to_numpy(tcore.mul_chunks(ta, tb)),
                                  np.asarray(jcore.mul_chunks(ja, jb)))
    np.testing.assert_array_equal(tcore.chunk_matches(ta, tm).numpy(),
                                  np.asarray(jcore.chunk_matches(ja, jm)))
    np.testing.assert_array_equal(tcore.decrypt_parity(ta, tm).numpy(),
                                  np.asarray(jcore.decrypt_parity(ja, jm)))


@pytest.mark.parametrize("t1,t2,w", [(1, 128, 4), (5, 256, 40), (3, 7, 4)])
def test_fill_anchor_matches_pallas(t1, t2, w):
    """K5's plain version against `fill_anchor_pallas` (interpret mode) on
    the first t1*t2 columns (the Pallas fill pads t1 up to its block; the
    port's fill, like its K1, writes no pad columns)."""
    seed = 0x9ABCDEF0
    want = np.asarray(jk.fill_anchor_pallas(jnp.asarray([seed], jnp.uint32), t1, t2, w))
    assert want.shape[1] >= t1 * t2
    got = kernels.fill_anchor(seed, t1, t2, w, device="cpu")
    assert got.shape == (w, t1 * t2)
    np.testing.assert_array_equal(words_to_numpy(got), want[:, :t1 * t2])
    # Only the seed's low 32 bits fill.
    assert torch.equal(kernels.fill_anchor((7 << 32) | seed, t1, t2, w, device="cpu"), got)
