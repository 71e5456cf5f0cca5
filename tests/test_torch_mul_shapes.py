"""The port's multiply and fused count at every shape class of the JAX
package's Pallas multiply family, bit-exactly: the tiled kernels (K6,
t2 = 256), the grouped kernel (K10, t2 in {1, 3, 37}) and the ragged kernels
(K11, t2 = 1030, their pad chunks stripped), each called directly as
csgn_tpu's own tests call them on the CPU (interpret mode); the dispatch
envelope at W = 40; and `kernels.mul_mode`, which picks the CUDA mode on
the card, at its boundaries.  Inputs are made from seeds with numpy.
Tolerance: 0 everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from csgn_tpu import layout as jl
from csgn_tpu.context import Context as JContext
from csgn_tpu.ops import dispatch as jdispatch
from csgn_tpu.ops import kernels as jk
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import dispatch, kernels

SMALL = JContext(100, 4)   # W = 4


def _operands(ctx, t1, t2, seed):
    """Canonical words a [W, t1], b [W, t2] and a key mask, with the mask
    ORed into some columns so the counts are not zero."""
    rng = np.random.default_rng(seed)
    mask = jl.bit_positions_to_mask(rng.choice(ctx.n, ctx.d, replace=False), ctx.n)
    a = rng.integers(0, 2**32, (ctx.words32, t1), dtype=np.uint32) & ctx.valid_mask[:, None]
    b = rng.integers(0, 2**32, (ctx.words32, t2), dtype=np.uint32) & ctx.valid_mask[:, None]
    a[:, ::2] |= mask[:, None]
    b[:, ::3] |= mask[:, None]
    return a, b, mask


def _port(a, b, mask):
    ta, tb, tm = (words_from_numpy(x, "cpu") for x in (a, b, mask))
    prod = words_to_numpy(kernels.mul_chunks(ta, tb))
    prod2, count = kernels.mul_decrypt(ta, tb, tm, return_count=True)
    _, parity = kernels.mul_decrypt(ta, tb, tm)
    np.testing.assert_array_equal(words_to_numpy(prod2), prod)
    assert int(parity) == int(count) & 1
    return prod, int(count)


def test_tiled_k6_matches_port():
    a, b, mask = _operands(SMALL, 5, 256, 1)
    assert jk.mul_tiled_supported(5, 256, SMALL.words32)
    prod, count = _port(a, b, mask)
    np.testing.assert_array_equal(prod, np.asarray(jk.mul_chunks_pallas_tiled(a, b)))
    jprod, jcount = jk.mul_decrypt_pallas_tiled(a, b, mask, return_count=True)
    np.testing.assert_array_equal(prod, np.asarray(jprod))
    assert count == int(jcount) >= 3 * 86
    _, jparity = jk.mul_decrypt_pallas_tiled(a, b, mask)
    assert int(jparity) == count & 1


@pytest.mark.parametrize("t2", [1, 3, 37])
def test_grouped_k10_matches_port(t2):
    a, b, mask = _operands(SMALL, 7, t2, t2)
    assert jk.mul_grouped_supported(7, t2, SMALL.words32)
    prod, count = _port(a, b, mask)
    np.testing.assert_array_equal(prod, np.asarray(jk.mul_chunks_pallas_grouped(a, b)))
    assert count >= 4 * len(range(0, t2, 3))


def test_ragged_k11_matches_port_without_pads():
    t1, t2 = 3, 1030
    a, b, mask = _operands(SMALL, t1, t2, 7)
    t2p = jk.ragged_padded(t2)
    assert t2p == 2048
    prod, count = _port(a, b, mask)
    w = SMALL.words32
    jprod = np.asarray(jk.mul_chunks_pallas_tiled_ragged(a, b))
    assert jprod.shape == (w, t1 * t2p)
    np.testing.assert_array_equal(jprod.reshape(w, t1, t2p)[..., :t2].reshape(w, -1), prod)
    assert not jprod.reshape(w, t1, t2p)[..., t2:].any()      # the pads are zero
    jprod2, jcount = jk.mul_decrypt_pallas_tiled_ragged(a, b, mask, return_count=True)
    np.testing.assert_array_equal(np.asarray(jprod2), jprod)
    assert count == int(jcount) >= 2 * 344


@pytest.mark.parametrize("t1,t2", [(1, 1), (4099, 1), (3, 37), (1021, 17), (2, 128), (16, 130)])
def test_dispatch_envelope_at_w40(ctx, t1, t2):
    """csgn_tpu's canonical dispatch against the port's at Context(1247, 16)."""
    a, b, mask = _operands(ctx, t1, t2, t1 + t2)
    prod = dispatch.mul_chunks(words_from_numpy(a, device="cpu"), words_from_numpy(b, device="cpu"))
    np.testing.assert_array_equal(words_to_numpy(prod),
                                  np.asarray(jdispatch.mul_chunks(jnp.asarray(a), jnp.asarray(b))))
    prod2, parity = dispatch.mul_decrypt(words_from_numpy(a, "cpu"), words_from_numpy(b, "cpu"),
                                         words_from_numpy(mask, device="cpu"))
    jprod, jparity = jdispatch.mul_decrypt(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    np.testing.assert_array_equal(words_to_numpy(prod2), np.asarray(jprod))
    assert int(parity) == int(jparity)


def test_mul_mode_boundaries():
    w = 40
    limit = kernels.B_STREAM_BYTES // (4 * w)       # the largest t2 that stays in L2
    assert kernels.B_STREAM_BYTES % (4 * w) == 0
    assert kernels.mul_mode(w, 16, limit, True) == "aligned"
    assert kernels.mul_mode(w, 16, limit + 1, True) == "tiled"
    assert kernels.mul_mode(w, 1, limit + 1, True) == "tiled"
    assert kernels.mul_mode(w, 3, limit + 1, False) == "tiled"
    for t1, t2, mode in [(1, 1, "unaligned"), (1, 2, "unaligned"), (1, 3, "unaligned"),
                         (1, 4, "aligned"), (2, 2, "aligned"), (3, 5, "unaligned"),
                         (4099, 37, "unaligned"), (151663, 111, "unaligned"),
                         (1021, 16411, "unaligned"), (4096, 4096, "aligned"),
                         (7, 12, "aligned")]:
        assert kernels.mul_mode(w, t1, t2, True) == mode, (t1, t2)
        assert kernels.mul_mode(w, t1, t2, False) == "unaligned", (t1, t2)
    # W only moves the streaming threshold (b's bytes).
    assert kernels.mul_mode(6, 3, limit + 1, True) == "unaligned"
    assert kernels.mul_mode(6, 4, 4 * limit, True) == "aligned"


@pytest.mark.parametrize("matches", ["all", "none", "some"])
@pytest.mark.parametrize("t1,t2", [(1, 1), (3, 37), (1021, 17), (16, 130)])
def test_count_is_matching_a_columns_times_matching_b_columns(ctx, t1, t2, matches):
    """The identity the card's fused count is computed by (csrc/mul.cu's
    column-match pass writes na * nb): the product's match count, from the
    port and from csgn_tpu's `mul_decrypt_count`, is the number of a's
    matching columns times b's; t1 * t2 when every chunk matches, 0 when
    none does."""
    a, b, mask = _operands(ctx, t1, t2, 3 * t1 + t2)
    if matches == "all":
        a |= mask[:, None]
        b |= mask[:, None]
    elif matches == "none":
        a &= ~mask[:, None]
        b &= ~mask[:, None]
    ta, tb, tm = (words_from_numpy(x, "cpu") for x in (a, b, mask))
    na = int(kernels.chunk_matches(ta, tm).sum())
    nb = int(kernels.chunk_matches(tb, tm).sum())
    _, count = kernels.mul_decrypt(ta, tb, tm, return_count=True)
    _, jcount = jdispatch.mul_decrypt_count(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    assert int(count) == int(jcount) == na * nb
    assert na * nb == {"all": t1 * t2, "none": 0}.get(matches, na * nb)
    if matches == "some":
        assert na >= len(range(0, t1, 2)) and nb >= len(range(0, t2, 3))
