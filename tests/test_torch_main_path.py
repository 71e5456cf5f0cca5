"""The slice end to end on the CPU: the port and csgn_tpu, given the same key
indices, seeds and bits, return equal words and parities; and the port
reproduces the reference's golden add/mul/decrypt vectors
(tests/golden/golden_vectors.json, as tests/test_golden.py:68-95 checks them
for csgn_tpu).
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu_torch import convert

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden_vectors.json"
SCENARIOS = json.loads(GOLDEN.read_text())["scenarios"]


def _both(ctx_j, seed):
    idx = np.random.default_rng(seed).choice(ctx_j.n, ctx_j.d, replace=False).astype(np.int32)
    tctx = T.Context(ctx_j.n, ctx_j.d)
    return J.SecretKey(ctx_j, idx), convert.secret_key_from_numpy(tctx, idx, device="cpu"), tctx


@pytest.mark.parametrize("ctx_name", ["ctx", "small_ctx"])
@pytest.mark.parametrize("t1,t2", [(1, 1), (5, 3), (7, 130), (1 << 14, 2)])
def test_port_equals_jax_on_the_main_path(request, ctx_name, t1, t2):
    ctx = request.getfixturevalue(ctx_name)
    jsk, tsk, tctx = _both(ctx, t1 * 10 + t2)
    rng = np.random.default_rng(t1 + t2)
    bits1 = rng.integers(0, 2, t1).astype(np.uint8)
    bits2 = rng.integers(0, 2, t2).astype(np.uint8)
    bits1[0], bits2[0] = 1, 1

    jw1 = np.asarray(jsk.encrypt_batch(jnp.asarray(bits1), 11, engine="counter"))
    jw2 = np.asarray(jsk.encrypt_batch(jnp.asarray(bits2), 12, engine="counter"))
    tw1 = tsk.encrypt_batch(torch.from_numpy(bits1), 11)
    tw2 = tsk.encrypt_batch(bits2, 12)
    np.testing.assert_array_equal(convert.words_to_numpy(tw1), jw1)
    np.testing.assert_array_equal(convert.words_to_numpy(tw2), jw2)

    j1, j2 = J.Ciphertext(jnp.asarray(jw1), ctx), J.Ciphertext(jnp.asarray(jw2), ctx)
    c1, c2 = T.Ciphertext(tw1, tctx), convert.ciphertext_from_numpy(jw2, tctx, device="cpu")
    np.testing.assert_array_equal((c1 + c2).to_u64(), (j1 + j2).to_u64())
    np.testing.assert_array_equal((c1 * c2).to_u64(), (j1 * j2).to_u64())

    tprod, tp = tsk.mul_and_decrypt(c1, c2)
    jprod, jp = jsk.mul_and_decrypt(j1, j2)
    np.testing.assert_array_equal(tprod.to_u64(), jprod.to_u64())
    xor1, xor2 = int(bits1.sum() % 2), int(bits2.sum() % 2)
    assert int(tp) == int(jp) == xor1 & xor2
    assert int(tsk.decrypt(tprod)) == int(jsk.decrypt(jprod)) == int(tp)
    assert int(tsk.decrypt(c1 + c2)) == int(jsk.decrypt(j1 + j2)) == xor1 ^ xor2
    np.testing.assert_array_equal(tsk.decrypt_batch(tw1).numpy(),
                                  np.asarray(jsk.decrypt_batch(jnp.asarray(jw1))))
    np.testing.assert_array_equal(tsk.decrypt_batch(tw2).numpy(), bits2)


@pytest.fixture(params=range(len(SCENARIOS)), ids=[f"n{s['n']}" for s in SCENARIOS])
def sc(request):
    return SCENARIOS[request.param]


def _import_ct(sc, name, ctx):
    return T.Ciphertext.from_u64(np.array([int(x) for x in sc[name]], dtype=np.uint64), ctx, "cpu")


def _words64(strs):
    return np.array([int(x) for x in strs], dtype=np.uint64)


def test_golden_add_mul_bit_exact(sc):
    ctx = T.Context(sc["n"], sc["d"])
    c1, c0 = _import_ct(sc, "c1", ctx), _import_ct(sc, "c0", ctx)
    added = c1 + c0
    np.testing.assert_array_equal(added.to_u64(), _words64(sc["added"]))
    np.testing.assert_array_equal((c1 * c0).to_u64(), _words64(sc["multiplied"]))
    big = added * added
    np.testing.assert_array_equal(big.to_u64(), _words64(sc["big"]))
    bigger = big * added
    np.testing.assert_array_equal(bigger.to_u64(), _words64(sc["bigger"]))
    biggest = bigger * added
    np.testing.assert_array_equal(biggest.to_u64(), _words64(sc["biggest"]))


def test_golden_decrypt_bit_exact(sc):
    ctx = T.Context(sc["n"], sc["d"])
    sk = T.SecretKey(ctx, np.array(sc["key"], dtype=np.int32), device="cpu")
    for name in ["c1", "c0", "added", "multiplied", "big", "bigger", "biggest"]:
        assert int(sk.decrypt(_import_ct(sc, name, ctx))) == sc["dec"][name], name
    _, parity = sk.mul_and_decrypt(_import_ct(sc, "added", ctx), _import_ct(sc, "added", ctx))
    assert int(parity) == sc["dec"]["big"]


def test_ciphertext_surface_matches_jax(ctx):
    """Serialization and accounting agree with csgn_tpu's Ciphertext."""
    jsk, tsk, tctx = _both(ctx, 3)
    jw = np.asarray(jsk.encrypt_batch(jnp.asarray([1, 0, 1], dtype=jnp.uint8), 5,
                                      engine="counter"))
    j = J.Ciphertext(jnp.asarray(jw), ctx)
    t = convert.ciphertext_from_numpy(jw, tctx, device="cpu")
    assert t.canonical() is t
    assert (t.chunks, t.nbytes, t.size(), t.bitlen) == (j.chunks, j.nbytes, j.size(), j.bitlen)
    assert t.bit_string() == j.bit_string()
    np.testing.assert_array_equal(t.chunk_major(), j.chunk_major())
    u64 = j.to_u64()
    np.testing.assert_array_equal(T.Ciphertext.from_u64(u64, tctx, device="cpu").to_u64(), u64)
    np.testing.assert_array_equal(
        T.Ciphertext.from_chunk_major(j.chunk_major(), tctx, device="cpu").to_u64(), u64)
    assert (tsk.size(), str(tsk)) == (jsk.size(), str(jsk))
    np.testing.assert_array_equal(tsk.mask, jsk.mask)


def test_key_side_helpers(small_ctx):
    tctx = T.Context(small_ctx.n, small_ctx.d)
    sk = T.SecretKey.generate(tctx, torch.Generator().manual_seed(0), device="cpu")
    assert len(set(sk.indices.tolist())) == tctx.d
    one, zero = sk.encrypt(T.Plaintext(1), 1), sk.encrypt(0, 2)
    assert (int(sk.decrypt(one)), int(sk.decrypt(zero))) == (1, 0)
    assert int(sk.decrypt_product([one, one, one])) == 1
    assert int(sk.decrypt_product([one, zero, one])) == 0
    fresh = sk.recrypt(one * one + zero, 3)
    assert fresh.chunks == 1 and int(sk.decrypt(fresh)) == 1
