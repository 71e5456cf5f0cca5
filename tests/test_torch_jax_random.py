"""The port's `jax.random` counterpart, `csgn_tpu_torch.rng`, and everything
the port draws from it, against `jax.random` and `csgn_tpu` on the CPU.

`rng.key`, `split`, `fold_in`, `bits`, `randint`, `uniform`, `bernoulli` and
`permutation` against `jax.random` (partitionable threefry, the conftest's
setting) over seeds and shapes; tests/torch_jax_draws.py's tables of JAX
draws (which the card tests and chip_smoke.py, having no JAX, hold the port
to) against JAX; `SecretKey.generate`,
`Permutation.random` and the default-engine `encrypt_batch`, `encrypt` and
`recrypt` against `csgn_tpu`, with the engine the argument selects; and the
two sharded encrypts of a gloo job of 1 and 2 CPU processes against
`csgn_tpu.parallel`'s on the 8-device virtual mesh.  Tolerance: exact.
"""

import hashlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import parallel as jpar
from csgn_tpu_torch import rng
from csgn_tpu_torch.layout import words_to_numpy
from csgn_tpu_torch.ops import encrypt_kernels as ek

import torch_jax_draws as draws

REPO = pathlib.Path(__file__).resolve().parent.parent
SEEDS = [0, 1, 2**31 - 1, -7]
SHAPES = [(), (5,), (40, 1000)]


def _data(k) -> list:
    return np.asarray(jax.random.key_data(k)).reshape(-1, 2).tolist()


def _port_data(keys) -> list:
    return [rng.key_data(k).tolist() for k in keys]


@pytest.mark.parametrize("seed", SEEDS + [2**31, 2**32 + 5, 2**40 + 3, -2**63, 2**63 - 1])
def test_key_is_jax_random_key(seed):
    assert rng.key_data(rng.key(seed)).tolist() == _data(jax.random.key(seed))[0]
    assert rng.wrap_key_data(rng.key_data(rng.key(seed))) == rng.key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in(seed):
    jk, k = jax.random.key(seed), rng.key(seed)
    for num in (1, 2, 3, 33, 256):       # both the Python-int and the tensor form
        assert _port_data(rng.split(k, num)) == _data(jax.random.split(jk, num))
    assert _port_data(rng.split(k)) == _data(jax.random.split(jk))
    for data in (0, 1, 2**31, 2**32 - 1):
        assert _port_data([rng.fold_in(k, data)]) == _data(jax.random.fold_in(jk, data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli(seed, shape):
    jk, k = jax.random.key(seed), rng.key(seed)
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
    got = rng.bits(k, shape)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = rng.uniform(k, shape)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    want = np.asarray(jax.random.bernoulli(jk, 0.9, shape))
    got = rng.bernoulli(k, 0.9, shape)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("span", [4, 16, 32, 2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed, span):
    jk, k = jax.random.key(seed), rng.key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.randint(jk, shape, 0, span))
        got = rng.randint(k, shape, 0, span)
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
        assert np.array_equal(got, want)
    for lo, hi in ((-5, span), (3, 3), (9, 2), (-2**31, 2**31 - 1), (5, 2**31 - 1)):
        assert np.array_equal(rng.randint(k, (64,), lo, hi),
                              np.asarray(jax.random.randint(jk, (64,), lo, hi)))


@pytest.mark.parametrize("n", [1, 2, 95, 1247, 4095])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
    got = rng.permutation(rng.key(seed), n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_key_arguments_are_checked():
    with pytest.raises(OverflowError):
        rng.key(2**63)
    with pytest.raises(OverflowError):
        jax.random.key(2**63)
    with pytest.raises(OverflowError):
        rng.fold_in(rng.key(0), -1)
    for bounds in ((0, 2**31), (-2**31 - 1, 0)):
        with pytest.raises(OverflowError):
            rng.randint(rng.key(0), (3,), *bounds)
        with pytest.raises(OverflowError):
            jax.random.randint(jax.random.key(0), (3,), *bounds)
    with pytest.raises(TypeError):
        rng.key(1.5)
    with pytest.raises(TypeError, match="rng.Key"):
        rng.split(0)
    with pytest.raises(ValueError):
        rng.Key(0, 2**32)


# ---------------------------------------------------------------------------
# tests/torch_jax_draws.py's JAX constants
# ---------------------------------------------------------------------------


def test_chip_smoke_rng_table_is_jax_random():
    """The table the main path's card test holds the port's rng to."""
    k = jax.random.key(draws.SEED)
    want = {
        "key_data": _data(k)[0],
        "split": _data(jax.random.split(k, 3)),
        "fold_in_7": _data(jax.random.fold_in(k, 7))[0],
        "bits": np.asarray(jax.random.bits(k, (2, 4), dtype=jnp.uint32)).tolist(),
        "randint_16": np.asarray(jax.random.randint(k, (8,), 0, 16)).tolist(),
        "randint_2p31m1": np.asarray(jax.random.randint(k, (4,), 0, 2**31 - 1)).tolist(),
        "bernoulli": np.asarray(jax.random.bernoulli(k, 0.9, (8,))).astype(int).tolist(),
        "permutation_16": np.asarray(jax.random.permutation(k, 16)).tolist(),
        "permutation_1247_head": np.asarray(jax.random.permutation(k, 1247))[:12].tolist(),
    }
    assert draws.RNG_VECTORS == want
    assert draws.rng_vectors(draws.SEED) == want


def test_chip_smoke_main_path_key_and_words_are_jax():
    """The main path's secret key and its two encrypt batches' words
    (sha-256), from JAX's CLI-demo derivation at Context(1247, 16)."""
    ctx = J.Context(1247, 16)
    keys = jax.random.split(jax.random.key(draws.SEED), 4)
    sk = J.SecretKey.generate(ctx, keys[0])
    assert sk.indices.tolist() == draws.MAIN_KEY_INDICES
    for key, bits, want in zip(keys[1:3], draws.main_bits(), draws.MAIN_WORDS_SHA256):
        words = np.asarray(sk.encrypt_batch(jnp.asarray(bits.astype(np.uint8)), key))
        assert hashlib.sha256(np.ascontiguousarray(words).tobytes()).hexdigest()[:32] == want


def test_chip_smoke_program_draws_are_jax():
    """The voting and auction draws of the examples at their default seed 0."""
    _, _, k_votes = jax.random.split(jax.random.key(0), 3)
    assert int(np.asarray(jax.random.bernoulli(k_votes, 0.9, (draws.MAIN_T,))).sum()) == \
        draws.VOTING_YES
    _, _, k_bids = jax.random.split(jax.random.key(0), 3)
    bid_draws = np.random.default_rng(int(jax.random.randint(k_bids, (), 0, 2**31 - 1)))
    bids = bid_draws.integers(0, 1 << 16, size=8)
    reserve = int(bid_draws.integers(0, 1 << 16))
    assert (reserve, [int(b > reserve) for b in bids]) == draws.AUCTION


# ---------------------------------------------------------------------------
# Keys, permutations and the default engine against csgn_tpu
# ---------------------------------------------------------------------------


def _keys(jctx, seed):
    tctx = T.Context(jctx.n, jctx.d)
    return (J.SecretKey.generate(jctx, jax.random.key(seed)),
            T.SecretKey.generate(tctx, rng.key(seed), device="cpu"))


@pytest.mark.parametrize("batch", [1, 127, 3000])
@pytest.mark.parametrize("n,d", [(95, 4), (1247, 16), (1024, 16)])
def test_default_engine_encrypt_batch_equals_jax(n, d, batch):
    jsk, tsk = _keys(J.Context(n, d), n + batch)
    assert np.array_equal(tsk.indices, jsk.indices)
    bits = np.random.default_rng(batch).integers(0, 2, batch).astype(np.uint8)
    want = np.asarray(jsk.encrypt_batch(jnp.asarray(bits), jax.random.key(batch)))
    got = tsk.encrypt_batch(bits.astype(np.int32), rng.key(batch))
    assert np.array_equal(words_to_numpy(got), want)
    # A slice of the batch: the whole encrypt's columns.
    lo, hi = batch // 3, batch - batch // 4
    part = ek.encrypt_bits_threefry(rng.key(batch), torch.from_numpy(bits[lo:hi].astype(np.int32)),
                                    *tsk.encrypt_operands, col0=lo, total=batch)
    assert np.array_equal(words_to_numpy(part), want[:, lo:hi])


def test_encrypt_and_recrypt_equal_jax(small_ctx):
    jsk, tsk = _keys(small_ctx, 3)
    for bit, seed in ((1, 10), (0, 11)):
        want = jsk.encrypt(bit, jax.random.key(seed))
        got = tsk.encrypt(bit, rng.key(seed))
        assert np.array_equal(words_to_numpy(got.wt), np.asarray(want.wt))
    jct = jsk.encrypt(1, jax.random.key(4)) * jsk.encrypt(1, jax.random.key(5))
    tct = tsk.encrypt(1, rng.key(4)) * tsk.encrypt(1, rng.key(5))
    assert np.array_equal(words_to_numpy(tct.wt), np.asarray(jct.wt))
    want, got = jsk.recrypt(jct, jax.random.key(6)), tsk.recrypt(tct, rng.key(6))
    assert np.array_equal(words_to_numpy(got.wt), np.asarray(want.wt))


@pytest.mark.parametrize("n", [95, 1247, 4095])
def test_permutation_random_equals_jax(n):
    want = J.Permutation.random(n, jax.random.key(n))
    got = T.Permutation.random(T.Context(n, 4), rng.key(n))
    assert np.array_equal(got.perm, want.perm) and got.perm.dtype == np.int32


def test_the_argument_selects_the_engine(small_ctx):
    """A key runs "threefry", an integer seed "counter" (both the JAX
    package's words), or "philox" when asked; a mismatch raises."""
    jsk, tsk = _keys(small_ctx, 5)
    bits = np.array([1, 0, 0, 1, 1], np.uint8)
    tb = bits.astype(np.int32)
    assert np.array_equal(words_to_numpy(tsk.encrypt_batch(tb, 77)), np.asarray(
        jsk.encrypt_batch(jnp.asarray(bits), 77, engine="counter")))
    assert np.array_equal(words_to_numpy(tsk.encrypt_batch(tb, rng.key(77), engine="threefry")),
                          np.asarray(jsk.encrypt_batch(jnp.asarray(bits), jax.random.key(77))))
    ops = tsk.encrypt_operands
    assert torch.equal(tsk.encrypt_batch(tb, 77, engine="philox"),
                       ek.encrypt_bits_philox_plain(77, torch.from_numpy(tb), *ops))
    for r, engine, err in ((rng.key(1), "counter", ValueError),
                           (rng.key(1), "philox", ValueError),
                           (1, "threefry", ValueError), (1, "pallas", ValueError),
                           (1.0, None, TypeError), (True, None, TypeError)):
        with pytest.raises(err):
            tsk.encrypt_batch(tb, r, engine=engine)
    with pytest.raises(TypeError, match="rng.Key"):
        T.SecretKey.generate(T.Context(95, 4), 0, device="cpu")


# ---------------------------------------------------------------------------
# The sharded encrypts: a gloo job of 1 and 2 processes against csgn_tpu
# ---------------------------------------------------------------------------

_RANK = """
import sys
import numpy as np, torch
from csgn_tpu_torch import Context, SecretKey, parallel, rng
from csgn_tpu_torch.layout import words_to_numpy
store, world, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
parallel.initialize(store, world, rank, device="cpu")
ctx = Context(95, 4)
sk = SecretKey.generate(ctx, rng.key(0), device="cpu")
bits = np.arange(16) % 3 % 2
bl = len(bits) // world
mine = torch.from_numpy(bits[rank * bl:(rank + 1) * bl].astype(np.int32))
mesh = parallel.chunk_mesh(world)
args = (mine, *sk.encrypt_operands, ctx.n, ctx.d, mesh)
np.savez(out, fold=words_to_numpy(parallel.sharded_encrypt_bits(rng.key(1), *args)),
         invariant=words_to_numpy(parallel.sharded_encrypt_bits_invariant(rng.key(1), *args)))
torch.distributed.destroy_process_group()
"""


def _gloo_job(world: int, tmp: pathlib.Path) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, f"file://{tmp}/store", str(world),
                               str(r), str(tmp / f"rank{r}.npz")], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_encrypts_equal_jax(world, tmp_path):
    """`sharded_encrypt_bits` under a key: JAX's per-device fold_in streams
    on a mesh of `world` devices; `sharded_encrypt_bits_invariant`: JAX's
    global stream, equal on the 8-device mesh."""
    outs = _gloo_job(world, tmp_path)
    ctx = J.Context(95, 4)
    sk = J.SecretKey.generate(ctx, jax.random.key(0))
    bits = jnp.asarray((np.arange(16) % 3 % 2).astype(np.uint8))
    args = (jnp.asarray(sk.indices), jnp.asarray(sk.mask), jnp.asarray(ctx.valid_mask), ctx.n,
            ctx.d)
    fold = jpar.sharded_encrypt_bits(jax.random.key(1), bits, *args, jpar.chunk_mesh(world))
    inv = jpar.sharded_encrypt_bits_invariant(jax.random.key(1), bits, *args,
                                              jpar.chunk_mesh(8))
    got = {k: np.concatenate([o[k] for o in outs], axis=-1) for k in ("fold", "invariant")}
    assert np.array_equal(got["fold"], np.asarray(fold))
    assert np.array_equal(got["invariant"], np.asarray(inv))
    assert np.array_equal(got["invariant"], np.asarray(sk.encrypt_batch(bits, jax.random.key(1))))
    if world > 1:
        assert not np.array_equal(got["fold"], got["invariant"])
