"""Column views of ciphertext words, which the JAX package accepts: the port
copies them to contiguous words on construction (`Ciphertext`,
`CiphertextBatch`) and in `SecretKey.decrypt_batch`, so its kernels' dense
row reads stay valid, and every call gives csgn_tpu's answer."""

import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu.batch import CiphertextBatch as JBatch
from csgn_tpu_torch import convert

BITS = np.array([1, 0, 1, 1], np.uint8)


@pytest.fixture
def both(ctx):
    idx = np.random.default_rng(12).choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    jsk = J.SecretKey(ctx, idx)
    tctx = T.Context(ctx.n, ctx.d)
    tsk = convert.secret_key_from_numpy(tctx, idx, device="cpu")
    jw = np.asarray(jsk.encrypt_batch(jnp.asarray(BITS), 5, engine="counter"))
    return jsk, tsk, J.Ciphertext(jnp.asarray(jw), ctx), \
        convert.ciphertext_from_numpy(jw, tctx, device="cpu"), tctx


def test_decrypt_of_a_column_view(both, ctx):
    jsk, tsk, jc, tc, tctx = both
    view = T.Ciphertext(tc.wt[:, :2], tctx)
    assert view.wt.is_contiguous()
    assert int(tsk.decrypt(view)) == int(jsk.decrypt(J.Ciphertext(jc.wt[:, :2], ctx))) == 1


def test_multiply_of_column_views(both, ctx):
    jsk, tsk, jc, tc, tctx = both
    tprod = T.Ciphertext(tc.wt[:, :2], tctx) * T.Ciphertext(tc.wt[:, 1:], tctx)
    jprod = J.Ciphertext(jc.wt[:, :2], ctx) * J.Ciphertext(jc.wt[:, 1:], ctx)
    np.testing.assert_array_equal(tprod.to_u64(), jprod.to_u64())
    tp, tpar = tsk.mul_and_decrypt(T.Ciphertext(tc.wt[:, 1:3], tctx),
                                   T.Ciphertext(tc.wt[:, :2], tctx))
    jp, jpar = jsk.mul_and_decrypt(J.Ciphertext(jc.wt[:, 1:3], ctx),
                                   J.Ciphertext(jc.wt[:, :2], ctx))
    np.testing.assert_array_equal(tp.to_u64(), jp.to_u64())
    assert int(tpar) == int(jpar) == 1


def test_decrypt_batch_of_a_column_view(both):
    jsk, tsk, jc, tc, tctx = both
    got = tsk.decrypt_batch(tc.wt[:, 1:3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsk.decrypt_batch(jc.wt[:, 1:3])))
    assert got.tolist() == [0, 1]


def test_batch_of_chunk_views(both, ctx):
    """`wt[:, :, a:b]` of a batch is not contiguous either."""
    jsk, tsk, jc, tc, tctx = both
    tb = T.CiphertextBatch.stack([tc, T.Ciphertext((tc + tc).wt[:, :4], tctx), tc])
    jb = JBatch(jnp.stack([jc.wt, (jc + jc).wt[:, :4], jc.wt]), ctx)
    view = T.CiphertextBatch(tb.wt[:, :, 1:3], tctx)
    assert view.wt.is_contiguous()
    np.testing.assert_array_equal(tsk.decrypt_batch(view).numpy(),
                                  np.asarray(jsk.decrypt_batch(JBatch(jb.wt[:, :, 1:3], ctx))))
    np.testing.assert_array_equal(tsk.decrypt_batch(tb.wt[:, :, 1:3]).numpy(), [1, 1, 1])
