"""The port's counter-engine encrypt (K4's plain path) against csgn_tpu's
`encrypt_bits_counter_ref` and the interpret-mode Pallas kernel, bit-exactly,
plus its threefry against the Random123 test vector.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgn_tpu.ops import encrypt_pallas as ep
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import encrypt_kernels as ek
from csgn_tpu_torch.ops import kernels


def _key(ctx, seed):
    from csgn_tpu import layout as jl

    idx = np.random.default_rng(seed).choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    return idx, jl.bit_positions_to_mask(idx, ctx.n)


def _port_args(ctx, idx, mask):
    return (torch.from_numpy(idx), words_from_numpy(mask, "cpu"),
            words_from_numpy(ctx.valid_mask, "cpu"))


def test_int64_to_int32_cast_wraps():
    """The plain versions compute uint32 values in int64 and rely on the cast
    wrapping them onto the int32 view."""
    x = torch.tensor([0, 2**31 - 1, 2**31, 2**32 - 1, 0x89ABCDEF], dtype=torch.int64)
    got = x.to(torch.int32).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.array([0, 2**31 - 1, 2**31, 2**32 - 1, 0x89ABCDEF],
                                                dtype=np.uint32))


def test_threefry_random123_vector():
    """Published Random123 threefry2x32-20 vector (tests/test_encrypt_pallas.py:95-106)."""
    y0, y1 = ek.threefry2x32(
        0x13198A2E, 0x03707344,
        torch.tensor([0x243F6A88], dtype=torch.int64),
        torch.tensor([0x85A308D3], dtype=torch.int64),
    )
    assert int(y0[0]) == 0xC4923A9C and int(y1[0]) == 0x483DF7A0


def test_threefry_matches_jax_helper():
    rng = np.random.default_rng(5)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint32)
    c0 = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    c1 = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    j0, j1 = ep._threefry2x32(int(k[0]), int(k[1]), jnp.asarray(c0), jnp.asarray(c1))
    t0, t1 = ek.threefry2x32(int(k[0]), int(k[1]), torch.from_numpy(c0.astype(np.int64)),
                             torch.from_numpy(c1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("ctx_name", ["ctx", "small_ctx"])
@pytest.mark.parametrize("batch", [1, 129, 300])
@pytest.mark.parametrize("seed", [0, 99, (7 << 32) | 12345])
def test_counter_encrypt_matches_ref(request, ctx_name, batch, seed):
    ctx = request.getfixturevalue(ctx_name)
    idx, mask = _key(ctx, batch)
    bits = np.random.default_rng(seed & 0xFFFF).integers(0, 2, batch).astype(np.uint8)
    want = np.asarray(ep.encrypt_bits_counter_ref(
        seed, jnp.asarray(bits), idx, mask, ctx.valid_mask, ctx.n, ctx.d))
    args = _port_args(ctx, idx, mask)
    plain = ek.encrypt_bits_counter_plain(seed, torch.from_numpy(bits), *args)
    np.testing.assert_array_equal(words_to_numpy(plain), want)
    wrapped = ek.encrypt_bits_counter(seed, torch.from_numpy(bits), *args)
    np.testing.assert_array_equal(words_to_numpy(wrapped), want)
    # Invariants: decrypt round trip and zero padding bits.
    m = words_from_numpy(mask, device="cpu")
    np.testing.assert_array_equal(kernels.chunk_matches(wrapped, m).numpy(), bits)
    assert not np.any(words_to_numpy(wrapped) & ~ctx.valid_mask[:, None])


def test_counter_encrypt_matches_interpret_kernel(ctx):
    """Batch 300 against the Pallas kernel itself, interpret mode, block_b=128."""
    idx, mask = _key(ctx, 300)
    bits = (np.arange(300) % 2).astype(np.uint8)
    want = np.asarray(ep.encrypt_bits_counter(
        99, jnp.asarray(bits), idx, mask, ctx.valid_mask, ctx.n, ctx.d, block_b=128))
    got = ek.encrypt_bits_counter(99, torch.from_numpy(bits), *_port_args(ctx, idx, mask))
    np.testing.assert_array_equal(words_to_numpy(got), want)


def test_counter_encrypt_is_batch_prefix_stable(small_ctx):
    idx, mask = _key(small_ctx, 1)
    args = _port_args(small_ctx, idx, mask)
    small = ek.encrypt_bits_counter(7, torch.tensor([1, 0, 1]), *args)
    big = ek.encrypt_bits_counter(7, torch.tensor([1, 0, 1] + [1] * 200), *args)
    assert torch.equal(big[:, :3], small)
