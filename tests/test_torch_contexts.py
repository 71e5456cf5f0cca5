"""Contexts made with `Context.with_n` and `Context.with_d`, including
n % 32 == 0 (an all-ones valid mask), through the port's API against
csgn_tpu: the derived fields, both encrypt engines, ``+``, ``*``,
`mul_and_decrypt` and decrypt (as tests/test_parity_surface.py:30 and
tests/test_invariant_encrypt.py:43 check them for the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
from csgn_tpu.ops import core as jcore
from csgn_tpu_torch import Ciphertext, Context, SecretKey
from csgn_tpu_torch.layout import words_to_numpy


def _pair(make):
    """The same derived context in both packages, from Context(1247, 16)."""
    return make(Context(1247, 16)), make(J.Context(1247, 16))


CONTEXTS = {
    "with_n(32)": lambda c: c.with_n(32),
    "with_n(64)": lambda c: c.with_n(64),
    "with_n(1024)": lambda c: c.with_n(1024),
    "with_n(95).with_d(4)": lambda c: c.with_n(95).with_d(4),
    "with_d(32)": lambda c: c.with_d(32),
}


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_derived_context_fields_equal_csgn_tpu(name):
    ctx, jctx = _pair(CONTEXTS[name])
    assert (ctx.n, ctx.d, ctx.s, ctx.words64, ctx.words32) == (
        jctx.n, jctx.d, jctx.s, jctx.words64, jctx.words32)
    assert tuple(ctx.bitlen) == tuple(jctx.bitlen)
    np.testing.assert_array_equal(ctx.valid_mask, jctx.valid_mask)
    assert str(ctx) == str(jctx)
    if ctx.n % 32 == 0:   # the words of bits [0, n) all ones, no partial word
        assert np.all(ctx.valid_mask[:ctx.n // 32] == np.uint32(0xFFFFFFFF))
        assert not np.any(ctx.valid_mask[ctx.n // 32:])


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_derived_context_through_the_api_equals_csgn_tpu(name):
    ctx, jctx = _pair(CONTEXTS[name])
    rng = np.random.default_rng(ctx.n * 100 + ctx.d)
    idx = rng.choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    sk, jsk = SecretKey(ctx, idx, device="cpu"), J.SecretKey(jctx, idx)
    bits1 = rng.integers(0, 2, 5).astype(np.uint8)
    bits2 = rng.integers(0, 2, 3).astype(np.uint8)
    bits1[0] = bits2[0] = 1

    # The counter engine: bit-equal to the JAX package's.
    w1, w2 = sk.encrypt_batch(bits1, 21), sk.encrypt_batch(bits2, 22)
    jw1 = jsk.encrypt_batch(jnp.asarray(bits1), 21, engine="counter")
    jw2 = jsk.encrypt_batch(jnp.asarray(bits2), 22, engine="counter")
    np.testing.assert_array_equal(words_to_numpy(w1), np.asarray(jw1))
    np.testing.assert_array_equal(words_to_numpy(w2), np.asarray(jw2))

    # The Philox engine: canonical words that the JAX package decrypts to the bits.
    pw = words_to_numpy(sk.encrypt_batch(bits1, 23, engine="philox"))
    assert not np.any(pw & ~ctx.valid_mask[:, None])
    np.testing.assert_array_equal(np.asarray(jsk.decrypt_batch(jnp.asarray(pw))), bits1)
    np.testing.assert_array_equal(
        np.asarray(jcore.chunk_matches(jnp.asarray(pw), jnp.asarray(jsk.mask))), bits1)

    c1, c2 = Ciphertext(w1, ctx), Ciphertext(w2, ctx)
    j1, j2 = J.Ciphertext(jw1, jctx), J.Ciphertext(jw2, jctx)
    x1, x2 = int(bits1.sum() % 2), int(bits2.sum() % 2)
    np.testing.assert_array_equal((c1 + c2).to_u64(), (j1 + j2).to_u64())
    np.testing.assert_array_equal((c1 * c2).to_u64(), (j1 * j2).to_u64())
    assert int(sk.decrypt(c1 + c2)) == int(jsk.decrypt(j1 + j2)) == x1 ^ x2
    assert int(sk.decrypt(c1 * c2)) == int(jsk.decrypt(j1 * j2)) == x1 & x2
    prod, parity = sk.mul_and_decrypt(c1, c2)
    jprod, jparity = jsk.mul_and_decrypt(j1, j2)
    np.testing.assert_array_equal(prod.to_u64(), jprod.to_u64())
    assert int(parity) == int(jparity) == x1 & x2
    np.testing.assert_array_equal(sk.decrypt_batch(w1).numpy(), bits1)
    assert torch.equal(sk.decrypt_batch(torch.from_numpy(pw.view(np.int32))),
                       torch.from_numpy(bits1.astype(np.int32)))
