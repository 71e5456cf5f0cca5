"""The Philox encrypt engine (K7's plain path) and its stream dump (K13's).

Philox-4x32-10 is pinned to the Random123 known-answer vectors and to
Python-int arithmetic; the stream spec to a Python-int implementation of it.
The JAX package's K7 draws from the TPU's hardware generator and has no CPU
lowering (tests/test_encrypt_pallas.py), so the engine is held to
`csgn_tpu` by invariants, not bits: canonical words, `chunk_matches` and
`SecretKey.decrypt_batch` of the JAX package equal to the bits, and the
statistics of the JAX package's tools/enc_stats.py at a small size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
from csgn_tpu.ops import core as jcore
from csgn_tpu_torch import Context, SecretKey
from csgn_tpu_torch.layout import bit_positions_to_mask, words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import encrypt_kernels as ek
from csgn_tpu_torch.tools import enc_stats

M32 = 0xFFFFFFFF


def philox_ref(ctr, key):
    """Philox-4x32-10 in Python ints, straight from the Random123 spec."""
    c, k = list(ctr), list(key)
    for i in range(10):
        if i:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & M32, p1 & M32, ((p0 >> 32) ^ c[3] ^ k[1]) & M32,
             p0 & M32]
    return c


def stream_ref(seed, rows, cols):
    """Stream rows of the spec: row 4g + l of column j is
    philox(ctr=(j, g, 0, 0), key=(seed_lo, seed_hi))[l]."""
    key = (seed & M32, (seed >> 32) & M32)
    return np.array([[philox_ref((j, r // 4, 0, 0), key)[r % 4] for j in cols]
                     for r in range(rows)], dtype=np.int64)


def _t(v):
    return torch.tensor([v], dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zero", "ones", "pi"])
def test_philox_random123_vectors(ctr, key, want):
    got = ek.philox4x32_10(*(_t(c) for c in ctr), *key)
    assert tuple(int(y[0]) for y in got) == want
    assert tuple(philox_ref(ctr, key)) == want


def test_mulhilo_matches_python_ints():
    rng = np.random.default_rng(11)
    xs = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                         np.array([0, 1, 0xFFFF, 0x10000, 2**31, M32], dtype=np.uint64)])
    for m in (0xD2511F53, 0xCD9E8D57, M32, 1, int(rng.integers(0, 2**32))):
        hi, lo = ek.mulhilo32(m, torch.from_numpy(xs.astype(np.int64)))
        want = [m * int(x) for x in xs]
        assert hi.tolist() == [p >> 32 for p in want]
        assert lo.tolist() == [p & M32 for p in want]


def test_philox_matches_python_ints_on_random_counters():
    rng = np.random.default_rng(12)
    ctr = rng.integers(0, 2**32, (4, 64), dtype=np.uint64).astype(np.int64)
    key = [int(k) for k in rng.integers(0, 2**32, 2)]
    got = ek.philox4x32_10(*(torch.from_numpy(c) for c in ctr), *key)
    for j in range(64):
        assert [int(y[j]) for y in got] == philox_ref([int(c[j]) for c in ctr], key)


@pytest.mark.parametrize("rows", [5, 6, 42, 130])
def test_streams_follow_the_spec(rows):
    """W = 3, 4, 40, 128: rows W and W + 1 straddle two groups at W = 3."""
    seed = (0x5EED << 32) | 77
    batch = 37
    want = stream_ref(seed, rows, range(batch))
    np.testing.assert_array_equal(ek.philox_streams_plain(seed, batch, rows, "cpu").numpy(),
                                  want)
    got = ek.philox_streams(seed, batch, rows, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(got).astype(np.int64), want)


def _key(ctx_n, d, seed):
    idx = np.random.default_rng(seed).choice(ctx_n, d, replace=False).astype(np.int32)
    return idx, bit_positions_to_mask(idx, ctx_n)


@pytest.mark.parametrize("n,d", [(95, 4), (1247, 16), (4095, 32)])
def test_philox_invariants_against_csgn_tpu(n, d):
    ctx, jctx = Context(n, d), J.Context(n, d)
    idx, _ = _key(n, d, n)
    bits = np.random.default_rng(d).integers(0, 2, 300).astype(np.int32)
    sk = SecretKey(ctx, idx, device="cpu")
    words = words_to_numpy(sk.encrypt_batch(bits, 987654321, engine="philox"))
    assert not np.any(words & ~ctx.valid_mask[:, None])              # canonical
    jsk = J.SecretKey(jctx, idx)
    np.testing.assert_array_equal(
        np.asarray(jcore.chunk_matches(jnp.asarray(words), jnp.asarray(jsk.mask))), bits)
    np.testing.assert_array_equal(np.asarray(jsk.decrypt_batch(jnp.asarray(words))), bits)
    # Not the counter engine's words.
    assert not np.array_equal(words, words_to_numpy(sk.encrypt_batch(bits, 987654321)))


def test_philox_straddling_rows_at_w3():
    """W = 3 (a raw 3-word mask; no Context has an odd W): rows W and W + 1
    lie in two Philox groups, and the words follow the spec's stream."""
    n, w = 95, 3
    idx, mask4 = _key(n, 4, 5)
    mask = mask4[:w]
    valid = np.array([M32, M32, 0xFFFFFFFE], dtype=np.uint32)
    bits = np.random.default_rng(1).integers(0, 2, 64).astype(np.int32)
    args = (torch.from_numpy(idx), words_from_numpy(mask, "cpu"), words_from_numpy(valid, "cpu"))
    got = ek.encrypt_bits_philox(42, torch.from_numpy(bits), *args)
    want = ek.derive_words(torch.from_numpy(stream_ref(42, w + 2, range(64))),
                           torch.from_numpy(bits), *args)
    assert torch.equal(got, want)
    u = words_to_numpy(got)
    matches = np.all((u & mask[:, None]) == mask[:, None], axis=0)
    np.testing.assert_array_equal(matches.astype(np.int32), bits)
    assert not np.any(u & ~valid[:, None])


def test_philox_batch_prefix_and_seed_sensitivity():
    ctx = Context(1247, 16)
    sk = SecretKey(ctx, _key(1247, 16, 2)[0], device="cpu")
    bits = [1, 0, 1] + [0] * 200
    big = sk.encrypt_batch(bits, 7, engine="philox")
    assert torch.equal(sk.encrypt_batch(bits[:3], 7, engine="philox"), big[:, :3])
    for other in (8, 7 + (1 << 32)):          # the low and the high seed word
        diff = sk.encrypt_batch(bits, other, engine="philox") != big
        assert int(diff.any(dim=0).sum()) == len(bits)        # every column changes


def test_philox_clone_fidelity():
    """The engine's words are the fix-up of `philox_streams`' rows."""
    ctx = Context(4095, 32)
    sk = SecretKey(ctx, _key(4095, 32, 3)[0], device="cpu")
    bits = torch.from_numpy(np.random.default_rng(3).integers(0, 2, 513))
    rows = ek.philox_streams(99, 513, ctx.words32 + 2, device="cpu").to(torch.int64) & M32
    assert torch.equal(sk.encrypt_batch(bits, 99, engine="philox"),
                       ek.derive_words(rows, bits, *sk.encrypt_operands))


def test_engine_names():
    sk = SecretKey(Context(95, 4), [1, 5, 9, 70], device="cpu")
    with pytest.raises(ValueError, match="unknown encrypt engine 'pallas'"):
        sk.encrypt_batch([1, 0], 1, engine="pallas")
    assert torch.equal(sk.encrypt_batch([1, 0], 1), sk.encrypt_batch([1, 0], 1, "counter"))


def test_enc_stats_at_d16():
    """tools/enc_stats.py's checks over 2^15 columns at Context(1247, 16):
    chi-square of r below 37.70 (df = 15, p = .001), |z| < 5, no collisions."""
    res = enc_stats.run(Context(1247, 16), 1 << 15, 424242, "cpu")
    assert res["ok"], res["failed"]
    assert res["chi2_limit"] == 37.70 and res["chi2"] < 37.70
    assert res["z_abs_max"] < 5
    assert res["clone_fidelity"] and res["adjacent_duplicates"] == 0
    assert res["cross_seed_shifted_equal"] == 0 and res["windows"] == 4
    assert sum(res["hist"]) == 1 << 15
