"""The port against the C++ reference: the golden encrypt replay, the golden
permutation generation, and random programs against the native C++ oracle.

  * `csgn_tpu_torch.refcompat` replays the reference's glibc `rand()` call
    sequences (`csgn_tpu_torch.rng.GlibcRand`) and reproduces the golden
    ciphertexts c1, c0 and the permutation of all three scenarios of
    tests/golden/golden_vectors.json (n = 95, 1247, 4095), which
    tools/dump_goldens.cpp dumped from the unmodified reference library —
    the counterparts of tests/test_golden.py:46-65 and :102-109, in pure
    Python at every n.
  * The replay equals the JAX package's `refcompat` and the native codec
    (`csgn_tpu.native.binding.NativeRand`) draw for draw.
  * Random add / mul / permute programs on the port's plain path (CPU
    tensors) agree, word for word after every step and in the final
    decrypts, with `csgn_tpu.native.binding.mul`, `decrypt` and `permute`,
    as tests/test_differential_fuzz.py holds the JAX package to them.

Tolerance: exact.
"""

import json
import pathlib

import numpy as np
import pytest

from csgn_tpu import refcompat as jref
from csgn_tpu.context import Context as JContext
from csgn_tpu.native import binding
from csgn_tpu.rng import GlibcRand as JGlibcRand
from csgn_tpu_torch import Ciphertext, Context, Permutation, SecretKey, refcompat
from csgn_tpu_torch.rng import GlibcRand

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden_vectors.json"
SCENARIOS = json.loads(GOLDEN.read_text())["scenarios"]


def _words64(strs) -> np.ndarray:
    return np.array([int(x) for x in strs], dtype=np.uint64)


@pytest.fixture(params=range(len(SCENARIOS)), ids=[f"n{s['n']}" for s in SCENARIOS])
def sc(request):
    return SCENARIOS[request.param]


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789])
def test_glibc_rand_matches_the_jax_package_and_the_native_codec(seed):
    ours, theirs, native = GlibcRand(seed), JGlibcRand(seed), binding.NativeRand(seed)
    got = [ours.rand() for _ in range(500)]
    assert got == [theirs.rand() for _ in range(500)] == [native.rand() for _ in range(500)]
    assert all(0 <= v < 2**31 for v in got)


def test_ref_encrypt_bit_exact(sc):
    """rand() replay of the reference's encrypt == the golden c1 and c0."""
    ctx = Context(sc["n"], sc["d"])
    key = np.array(sc["key"], dtype=np.int32)
    for seed_name, ct_name, bit in [("seed1", "c1", 1), ("seed0", "c0", 0)]:
        ours = refcompat.ref_encrypt_words(GlibcRand(sc[seed_name]), bit, key, ctx)
        golden = Ciphertext.from_u64(_words64(sc[ct_name]), ctx, device="cpu")
        np.testing.assert_array_equal(ours[None], golden.chunk_major(), err_msg=ct_name)
        assert int(SecretKey(ctx, key, device="cpu").decrypt(golden)) == bit


def test_ref_permutation_bit_exact(sc):
    """rand() replay of the reference's permutation generation == the golden
    permutation, and the port's key transform of it == the golden key."""
    n = sc["n"]
    perm = refcompat.ref_permutation(GlibcRand(sc["perm_seed"]), n)
    np.testing.assert_array_equal(perm, np.array(sc["perm"], dtype=np.int32))
    p = Permutation(perm)
    np.testing.assert_array_equal(p.inverse().perm, np.array(sc["inv_perm"], dtype=np.int32))
    sk = SecretKey(Context(n, sc["d"]), np.array(sc["key"], dtype=np.int32), device="cpu")
    np.testing.assert_array_equal(sk.apply_permutation(p).indices,
                                  np.array(sc["permuted_key"], dtype=np.int32))


@pytest.mark.parametrize("n,d,seed", [(95, 4, 3), (1247, 16, 9), (4095, 32, 17)])
def test_replay_equals_the_jax_package_and_the_native_codec(n, d, seed):
    """Keygen, both encrypt branches and a permutation, consumed from one
    stream in one order, equal the JAX package's replay and the native codec."""
    ctx, jctx = Context(n, d), JContext(n, d)
    g, jg = GlibcRand(seed), JGlibcRand(seed)
    key = refcompat.ref_keygen_indices(g, ctx)
    np.testing.assert_array_equal(key, jref.ref_keygen_indices(jg, jctx))
    assert len(set(key.tolist())) == d
    nat = binding.NativeRand(seed + 1)
    g1 = GlibcRand(seed + 1)
    for bit in (1, 0, 0, 1):
        ours = refcompat.ref_encrypt_words(g, bit, key, ctx)
        np.testing.assert_array_equal(ours, jref.ref_encrypt_words(jg, bit, key, jctx))
        np.testing.assert_array_equal(refcompat.ref_encrypt_words(g1, bit, key, ctx),
                                      nat.ref_encrypt(bit, key, n))
    np.testing.assert_array_equal(refcompat.ref_permutation(g, n), jref.ref_permutation(jg, n))
    np.testing.assert_array_equal(refcompat.ref_permutation(g1, n), nat.ref_permutation(n))


def _program(ctx: Context, seed: int, steps: int, max_chunks: int, ops: list[str]) -> None:
    """A random add / mul / permute / fresh program on the port's plain path
    and the native oracle side by side, compared after every step."""
    rng = np.random.default_rng(seed)
    sk = SecretKey(ctx, rng.choice(ctx.n, ctx.d, replace=False), device="cpu")
    perm = Permutation(rng.permutation(ctx.n).astype(np.int32))
    inv = perm.inverse()
    bits = [int(rng.integers(0, 2)) for _ in range(2)]
    cts = [sk.encrypt(b, seed * 100 + i) for i, b in enumerate(bits)]
    natives = [ct.chunk_major() for ct in cts]
    plains = list(bits)
    for step in range(steps):
        op = rng.choice(ops)
        i, j = int(rng.integers(0, len(cts))), int(rng.integers(0, len(cts)))
        if op == "add":
            cts[i] = cts[i] + cts[j]
            natives[i] = np.concatenate([natives[i], natives[j]])
            plains[i] ^= plains[j]
        elif op == "mul":
            if cts[i].chunks * cts[j].chunks > max_chunks:
                continue
            cts[i] = cts[i] * cts[j]
            natives[i] = binding.mul(natives[i], natives[j])
            plains[i] &= plains[j]
        elif op == "permute":
            # p then p^-1 keeps one key for the final decrypts; the permuted
            # words are compared in between.
            cts[i] = cts[i].apply_permutation(perm)
            natives[i] = binding.permute(natives[i], perm.perm, ctx.n)
            np.testing.assert_array_equal(cts[i].chunk_major(), natives[i])
            cts[i] = cts[i].apply_permutation(inv)
            natives[i] = binding.permute(natives[i], inv.perm, ctx.n)
        else:
            b = int(rng.integers(0, 2))
            cts.append(sk.encrypt(b, seed * 100 + 50 + step))
            natives.append(cts[-1].chunk_major())
            plains.append(b)
        for k, (ct, nat) in enumerate(zip(cts, natives)):
            np.testing.assert_array_equal(ct.chunk_major(), nat,
                                          err_msg=f"seed={seed} step={step} ct={k}")
    for ct, nat, plain in zip(cts, natives, plains):
        assert int(sk.decrypt(ct)) == binding.decrypt(nat, sk.mask) == plain


@pytest.mark.parametrize("seed", range(8))
def test_random_program_vs_native(seed):
    _program(Context(95, 4), seed, 6, 128, ["add", "mul", "permute", "fresh"])


@pytest.mark.parametrize("seed", range(3))
def test_random_program_vs_native_large_params(seed):
    """Context(4095, 32): 128 words a chunk, the shared path's width."""
    _program(Context(4095, 32), 1000 + seed, 4, 32, ["add", "mul", "permute"])
