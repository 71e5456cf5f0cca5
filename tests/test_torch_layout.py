"""The port's layout helpers against csgn_tpu.layout, bit-exactly.

Inputs are made by numpy from fixed seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgn_tpu import layout as jl
from csgn_tpu.context import Context as JContext
from csgn_tpu_torch import layout as tl
from csgn_tpu_torch.context import Context as TContext

NS = [1, 31, 32, 33, 64, 95, 1247]


@pytest.mark.parametrize("n", NS)
def test_pack_unpack_bits_match_jax(n):
    bits = np.random.default_rng(n).integers(0, 2, size=(3, n)).astype(np.uint8)
    want = np.asarray(jl.pack_bits(jnp.asarray(bits)))
    got = tl.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(tl.words_to_numpy(got), want)
    back = tl.unpack_bits(got, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(jl.unpack_bits(jnp.asarray(want), n)))
    np.testing.assert_array_equal(back, bits)


@pytest.mark.parametrize("n", NS)
def test_pack_unpack_bits_wc_match_jax(n):
    bits = np.random.default_rng(100 + n).integers(0, 2, size=(2, n, 5)).astype(np.uint8)
    want = np.asarray(jl.pack_bits_wc(jnp.asarray(bits)))
    got = tl.pack_bits_wc(torch.from_numpy(bits))
    np.testing.assert_array_equal(tl.words_to_numpy(got), want)
    back = tl.unpack_bits_wc(got, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(jl.unpack_bits_wc(jnp.asarray(want), n)))
    np.testing.assert_array_equal(back, bits)


def test_numpy_crossing_is_bit_identical():
    """uint32 words with the top bit set survive the int32 view both ways."""
    a = np.array([[0, 1, 0x7FFFFFFF], [0x80000000, 0xDEADBEEF, 0xFFFFFFFF]], dtype=np.uint32)
    t = tl.words_from_numpy(a, device="cpu")
    assert t.dtype == torch.int32 and t[1, 0].item() == -(2**31)
    back = tl.words_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, a)


def test_u64_interop_matches_jax():
    rng = np.random.default_rng(7)
    w64 = rng.integers(0, 2**63, size=(4, 20), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    np.testing.assert_array_equal(tl.u64_to_u32(w64), jl.u64_to_u32(w64))
    np.testing.assert_array_equal(tl.u32_to_u64(tl.u64_to_u32(w64)), w64)


@pytest.mark.parametrize("n,d", [(1247, 16), (95, 4), (4095, 32), (64, 1)])
def test_context_and_masks_match_jax(n, d):
    tc, jc = TContext(n, d), JContext(n, d)
    assert (tc.s, tc.words64, tc.words32, tc.bitlen) == (jc.s, jc.words64, jc.words32, jc.bitlen)
    np.testing.assert_array_equal(tc.valid_mask, jc.valid_mask)
    pos = np.random.default_rng(n).choice(n, d, replace=False)
    np.testing.assert_array_equal(tl.bit_positions_to_mask(pos, n),
                                  jl.bit_positions_to_mask(pos, n))
    words = np.random.default_rng(d).integers(0, 2**32, size=(2, tc.words32), dtype=np.uint32)
    assert tl.format_bits(words, n) == jl.format_bits(words, n)
