"""The port's batch slice on the CPU against csgn_tpu, bit-exactly:
`CiphertextBatch` (from_fresh / stack / + / * / apply_permutation(s) /
to_u64), `SecretKey.decrypt_batch` on [B, W, C] and `mul_and_decrypt_batch`
against csgn_tpu.batch; the batched K1-K3 wrappers against their 2-D calls
and csgn_tpu's batched dispatch; the two faults the port repairs instead of
copying; and the key-rotation flow of examples/key_rotation.py with shared
permutation arrays.  Keys, bits, seeds and permutations are made by numpy
and handed to both packages (the counter encrypt engine is bit-exact across
them).  Tolerance: 0 everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import layout as jl
from csgn_tpu.batch import CiphertextBatch as JBatch
from csgn_tpu.ops import dispatch as jdispatch
from csgn_tpu_torch import convert
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import dispatch, kernels


def _keys(ctx, seed):
    idx = np.random.default_rng(seed).choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    tctx = T.Context(ctx.n, ctx.d)
    return J.SecretKey(ctx, idx), convert.secret_key_from_numpy(tctx, idx, device="cpu"), tctx


def _fresh(jsk, bits, seed):
    """Fresh words [W, B] from csgn_tpu's counter encrypt (the port's
    `encrypt_batch(bits, seed)` gives the same words)."""
    return np.asarray(jsk.encrypt_batch(jnp.asarray(bits, dtype=jnp.uint8), seed,
                                        engine="counter"))


def test_batch_surface_matches_jax(small_ctx):
    jsk, tsk, tctx = _keys(small_ctx, 1)
    bits = np.array([1, 0, 1, 1, 0], np.uint8)
    jw, jw2 = _fresh(jsk, bits, 3), _fresh(jsk, 1 - bits, 4)
    np.testing.assert_array_equal(words_to_numpy(tsk.encrypt_batch(bits, 3)), jw)
    jb, jb2 = JBatch.from_fresh(jnp.asarray(jw), small_ctx), JBatch.from_fresh(jnp.asarray(jw2),
                                                                              small_ctx)
    tb, tb2 = T.CiphertextBatch.from_fresh(words_from_numpy(jw, device="cpu"), tctx), \
        T.CiphertextBatch.from_fresh(tsk.encrypt_batch(1 - bits, 4), tctx)
    np.testing.assert_array_equal(words_to_numpy(tb.wt), np.asarray(jb.wt))
    np.testing.assert_array_equal(words_to_numpy(tb.to_fresh()), jw)
    assert (tb.batch, tb.chunks, tb.nbytes) == (jb.batch, jb.chunks, jb.nbytes)
    assert tb.canonical() is tb

    for tx, jx in [(tb * tb2, jb * jb2),                      # fresh x fresh: one AND
                   (tb + tb2, jb + jb2),
                   ((tb + tb2) * (tb2 + tb + tb), (jb + jb2) * (jb2 + jb + jb))]:
        np.testing.assert_array_equal(tx.to_u64(), jx.to_u64())
        assert tx.chunks == jx.chunks
    grown = (tb + tb2) * (tb2 + tb + tb)
    np.testing.assert_array_equal(grown[2].to_u64(), ((jb + jb2) * (jb2 + jb + jb))[2].to_u64())
    assert isinstance(grown[2], T.Ciphertext)
    stacked = T.CiphertextBatch.stack([grown[i] for i in range(grown.batch)])
    assert torch.equal(stacked.wt, grown.wt)
    back = convert.ciphertext_batch_from_numpy(words_to_numpy(grown.wt), tctx, device="cpu")
    assert torch.equal(back.wt, grown.wt)


@pytest.mark.parametrize("ctx_name", ["ctx", "small_ctx"])
def test_batch_decrypts_match_jax(request, ctx_name):
    ctx = request.getfixturevalue(ctx_name)
    jsk, tsk, tctx = _keys(ctx, 2)
    rng = np.random.default_rng(5)
    bits_a = rng.integers(0, 2, (6, 7)).astype(np.uint8)   # 6 elements x 7 chunks
    bits_b = rng.integers(0, 2, (6, 5)).astype(np.uint8)
    cts = {}
    for name, bits in [("a", bits_a), ("b", bits_b)]:
        words = [_fresh(jsk, row, 100 + 10 * i + len(name)) for i, row in enumerate(bits)]
        cts[name] = (JBatch(jnp.stack([jnp.asarray(w) for w in words]), ctx),
                     T.CiphertextBatch.stack([convert.ciphertext_from_numpy(w, tctx, device="cpu")
                                              for w in words]))
    (ja, ta), (jb, tb) = cts["a"], cts["b"]
    xa, xb = bits_a.sum(axis=1) % 2, bits_b.sum(axis=1) % 2
    assert 0 < xa.sum() < 6 and 0 < (xa & xb).sum()   # both parities present

    np.testing.assert_array_equal(tsk.decrypt_batch(ta).numpy(), xa)
    np.testing.assert_array_equal(tsk.decrypt_batch(ta.wt).numpy(),
                                  np.asarray(jsk.decrypt_batch(ja)))
    tprod, tbits = tsk.mul_and_decrypt_batch(ta, tb)
    jprod, jbits = jsk.mul_and_decrypt_batch(ja, jb)
    np.testing.assert_array_equal(tprod.to_u64(), jprod.to_u64())
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tbits.numpy(), xa & xb)
    np.testing.assert_array_equal(tsk.decrypt_batch(ta * tb).numpy(), xa & xb)
    assert tbits.dtype == tsk.decrypt_batch(ta).dtype == torch.int32
    for i in range(6):
        assert int(tsk.decrypt(tprod[i])) == int(xa[i] & xb[i])
    with pytest.raises(ValueError, match="batch mismatch"):
        tsk.mul_and_decrypt_batch(ta, T.CiphertextBatch(tb.wt[:2], tctx))
    with pytest.raises(TypeError):
        tsk.mul_and_decrypt_batch(ta, tb[0])
    with pytest.raises(ValueError, match="W="):
        tsk.decrypt_batch(ta.wt[:, :-1])


def test_batched_kernels_match_2d_calls_and_jax(ctx):
    """K1-K3 on [B, W, C] equal their 2-D calls element by element, and the
    batched dispatch equals csgn_tpu's (canonical, no pads)."""
    rng = np.random.default_rng(9)
    mask = jl.bit_positions_to_mask(rng.choice(ctx.n, ctx.d, replace=False), ctx.n)
    a = rng.integers(0, 2**32, (4, ctx.words32, 3), dtype=np.uint32) & ctx.valid_mask[:, None]
    b = rng.integers(0, 2**32, (4, ctx.words32, 130), dtype=np.uint32) & ctx.valid_mask[:, None]
    a[[0, 1, 3], :, 1] |= mask
    b[:, :, [5, 77]] |= mask[:, None]
    ta, tb, tm = (words_from_numpy(x, "cpu") for x in (a, b, mask))

    prod = dispatch.mul_chunks_batched(ta, tb)
    jprod, jmajor, zpa, zpb = jdispatch.mul_chunks_batched(jnp.asarray(a), jnp.asarray(b))
    assert (jmajor, zpa, zpb) == (False, 0, 0)
    np.testing.assert_array_equal(words_to_numpy(prod), np.asarray(jprod))
    prod2, par = dispatch.mul_decrypt_batched(ta, tb, tm)
    jprod2, jpar = jdispatch.mul_decrypt_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    np.testing.assert_array_equal(words_to_numpy(prod2), np.asarray(jprod2))
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    _, count = kernels.mul_decrypt(ta, tb, tm, return_count=True)
    np.testing.assert_array_equal(count.numpy(), [2, 2, 0, 2])
    for i in range(4):
        assert torch.equal(prod[i], kernels.mul_chunks(ta[i], tb[i]))
        assert int(count[i]) == int(kernels.mul_decrypt(ta[i], tb[i], tm, return_count=True)[1])
        assert int(dispatch.decrypt_parity(prod, tm)[i]) == int(kernels.decrypt_parity(prod[i], tm))
        assert torch.equal(kernels.chunk_matches(prod, tm)[i], kernels.chunk_matches(prod[i], tm))
    with pytest.raises(ValueError, match=r"\[B, W, chunks\]"):
        kernels.mul_chunks(ta, tb[:2])
    with pytest.raises(ValueError, match=r"\[B, W, chunks\]"):
        kernels.mul_chunks(ta, tb[0])


def test_batch_permutations_match_jax(ctx):
    jsk, tsk, tctx = _keys(ctx, 4)
    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, (3, ctx.words32, 9), dtype=np.uint32) & ctx.valid_mask[:, None]
    jb = JBatch(jnp.asarray(words), ctx)
    tb = convert.ciphertext_batch_from_numpy(words, tctx, "cpu")
    perms = [rng.permutation(ctx.n) for _ in range(3)]
    jps = [J.Permutation(p) for p in perms]
    tps = [convert.permutation_from_numpy(p) for p in perms]
    np.testing.assert_array_equal(tb.apply_permutations(tps).to_u64(),
                                  jb.apply_permutations(jps).to_u64())
    np.testing.assert_array_equal(tb.apply_permutation(tps[1]).to_u64(),
                                  jb.apply_permutation(jps[1]).to_u64())
    with pytest.raises(ValueError, match="need 3"):
        tb.apply_permutations(tps[:2])
    with pytest.raises(ValueError, match="length"):
        tb.apply_permutation(T.Permutation.identity(ctx.n - 1))


def test_repaired_faults_non_batch_operand_and_empty_batch(small_ctx):
    """The JAX package's batch raises inside `+`/`*` on a non-batch operand
    (so `batch + expr` fails while `expr + batch` works) and accepts B = 0;
    the port returns NotImplemented and rejects empty batches."""
    _, tsk, tctx = _keys(small_ctx, 7)
    tb = T.CiphertextBatch.from_fresh(tsk.encrypt_batch([1, 0], 1), tctx)
    ct = tsk.encrypt(1, 2)
    assert tb.__add__(ct) is NotImplemented and tb.__mul__(ct) is NotImplemented
    assert tb.__add__(3) is NotImplemented
    for op in (lambda: tb + ct, lambda: tb * ct, lambda: ct + tb, lambda: tb * 2):
        with pytest.raises(TypeError):
            op()
    with pytest.raises(ValueError, match="empty batch"):
        T.CiphertextBatch(tb.wt[:0], tctx)
    with pytest.raises(ValueError, match="empty batch"):
        T.CiphertextBatch.from_fresh(tsk.encrypt_batch(np.zeros(0, np.int32), 1), tctx)
    with pytest.raises(ValueError, match="empty batch"):
        T.CiphertextBatch.stack([])
    with pytest.raises(ValueError, match=r"\[B, W=4, chunks\]"):
        T.CiphertextBatch(tb.wt[0], tctx)
    with pytest.raises(ValueError, match="batch mismatch"):
        tb + T.CiphertextBatch.from_fresh(tsk.encrypt_batch([1], 1), tctx)


def test_key_rotation_flow_matches_jax(ctx):
    """examples/key_rotation.py at fleet 8, with the permutations shared as
    numpy arrays: encrypt a fleet, grow it with `*`, rotate element i under
    its own π_i, and decrypt each under its rotated key."""
    fleet = 8
    jsk, tsk, tctx = _keys(ctx, 0)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, fleet).astype(np.uint8)
    ones = np.ones(fleet, np.uint8)
    perms = [rng.permutation(ctx.n) for _ in range(fleet)]

    jbatch = JBatch.from_fresh(jnp.asarray(_fresh(jsk, bits, 1)), ctx) + \
        JBatch.from_fresh(jnp.asarray(_fresh(jsk, ones, 2)), ctx)
    jrot = (jbatch * jbatch).apply_permutations([J.Permutation(p) for p in perms])

    tbatch = T.CiphertextBatch.from_fresh(tsk.encrypt_batch(bits, 1), tctx) + \
        T.CiphertextBatch.from_fresh(tsk.encrypt_batch(ones, 2), tctx)
    tps = [T.Permutation(p) for p in perms]
    trot = (tbatch * tbatch).apply_permutations(tps)
    np.testing.assert_array_equal(trot.to_u64(), jrot.to_u64())

    want = [int(b) ^ 1 for b in bits]
    decs = [int(tsk.apply_permutation(tps[i]).decrypt(trot[i])) for i in range(fleet)]
    assert decs == want and 0 < sum(want) < fleet
    assert int(jsk.apply_permutation(J.Permutation(perms[3])).decrypt(jrot[3])) == want[3]
