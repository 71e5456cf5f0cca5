"""The port's circuit layer against csgn_tpu.circuit and csgn_tpu's
SecretKey, bit-exactly: `CtExpr` construction and chunk saturation,
`fold`/`fold_many`, `materialize` (words equal), `apply_permutation`,
`decrypt_circuit`/`decrypt_circuits`/`decrypt_batches_packed`, and fleet
DAGs over `CiphertextBatch` leaves with their guards.  The same words cross
as numpy arrays; the same DAG is built on both sides.  Tolerance: 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import circuit as jc
from csgn_tpu.batch import CiphertextBatch as JBatch
from csgn_tpu_torch import circuit as tc
from csgn_tpu_torch import convert


class Pair:
    """One key and its leaves, in both packages."""

    def __init__(self, ctx, seed):
        self.rng = np.random.default_rng(seed)
        idx = self.rng.choice(ctx.n, ctx.d, replace=False).astype(np.int32)
        self.ctx, self.tctx = ctx, T.Context(ctx.n, ctx.d)
        self.jsk = J.SecretKey(ctx, idx)
        self.tsk = convert.secret_key_from_numpy(self.tctx, idx, device="cpu")
        self.seed = seed

    def words(self, bits):
        self.seed += 1
        return np.asarray(self.jsk.encrypt_batch(jnp.asarray(np.asarray(bits, np.uint8)),
                                                 self.seed, engine="counter"))

    def ct(self, bits):
        w = self.words(bits)
        return (J.Ciphertext(jnp.asarray(w), self.ctx),
                convert.ciphertext_from_numpy(w, self.tctx, "cpu"))

    def batch(self, bits_bc):
        """Batch leaves: element e holds bits_bc[e] as its chunks."""
        w = np.stack([self.words(row) for row in bits_bc])
        return (JBatch(jnp.asarray(w), self.ctx),
                convert.ciphertext_batch_from_numpy(w, self.tctx, "cpu"))


def _dag(lift, a, b, c):
    """A true DAG: `shared` is used twice."""
    shared = lift(a) * b
    return (shared + c) * (shared + a) + lift(c) * c


@pytest.fixture
def pair(ctx):
    return Pair(ctx, 7)


def test_expr_construction_materialize_and_fold(pair):
    (ja, ta), (jb, tb), (jcc, tcc) = pair.ct([1, 0, 1]), pair.ct([1, 1]), pair.ct([0, 1, 1, 1])
    je, te = _dag(jc.lift, ja, jb, jcc), _dag(tc.lift, ta, tb, tcc)
    assert (te.op, te.chunks, te.batch) == (je.op, je.chunks, je.batch) == ("add", 106, None)
    assert te.nbytes_materialized == je.nbytes_materialized
    assert len(te.leaves()) == len(je.leaves()) == 3
    np.testing.assert_array_equal(te.materialize().to_u64(), je.materialize().to_u64())
    want = int(pair.jsk.decrypt(je.materialize()))
    assert int(pair.tsk.decrypt_circuit(te)) == int(pair.jsk.decrypt_circuit(je)) == want
    assert te.fold(lambda ct: int(pair.tsk.decrypt(ct))) == want
    # Reflected operators: a Ciphertext on the left defers to the CtExpr.
    assert (ta + tc.lift(tb)).chunks == 5 and (ta * tc.lift(tb)).op == "mul"
    with pytest.raises(TypeError, match="cannot lift"):
        tc.lift(3)


def test_fold_many_and_decrypt_circuits(pair):
    (ja, ta), (jb, tb), (jcc, tcc) = pair.ct([1]), pair.ct([1, 0, 0]), pair.ct([0])
    jroots = [_dag(jc.lift, ja, jb, jcc), jc.lift(ja) * jb, jc.lift(jcc) + ja]
    troots = [_dag(tc.lift, ta, tb, tcc), tc.lift(ta) * tb, tc.lift(tcc) + ta]
    troots.append(troots[1])                      # a repeated root
    jroots.append(jroots[1])
    tbits = tc.fold_many(troots, lambda ct: int(pair.tsk.decrypt(ct)))
    jbits = jc.fold_many(jroots, lambda ct: int(pair.jsk.decrypt(ct)))
    assert tbits == jbits
    assert [int(v) for v in pair.tsk.decrypt_circuits(troots)] == tbits
    assert [int(v) for v in pair.jsk.decrypt_circuits(jroots)] == tbits
    assert [int(pair.tsk.decrypt_circuit(e)) for e in troots] == tbits
    assert len(tc.collect_leaves(troots)) == len(jc.collect_leaves(jroots)) == 3
    assert sum(tbits) > 0                          # not all zero


def test_apply_permutation_pushes_to_leaves(pair):
    (ja, ta), (jb, tb), (jcc, tcc) = pair.ct([1, 1, 0]), pair.ct([1]), pair.ct([0, 1])
    perm = pair.rng.permutation(pair.ctx.n)
    jp, tp = J.Permutation(perm), convert.permutation_from_numpy(perm)
    je = _dag(jc.lift, ja, jb, jcc).apply_permutation(jp)
    te = _dag(tc.lift, ta, tb, tcc).apply_permutation(tp)
    np.testing.assert_array_equal(te.materialize().to_u64(), je.materialize().to_u64())
    assert int(pair.tsk.apply_permutation(tp).decrypt_circuit(te)) == \
        int(pair.tsk.decrypt_circuit(_dag(tc.lift, ta, tb, tcc)))


def test_saturated_chunk_accounting():
    assert tc.CHUNKS_SAT == jc.CHUNKS_SAT
    for x, y in [(0, 5), (3, 4), (1 << 62, 1 << 62), (1 << 40, 1 << 40), (tc.CHUNKS_SAT, 2),
                 (7, tc.CHUNKS_SAT)]:
        assert tc.sat_add(x, y) == jc.sat_add(x, y)
        assert tc.sat_mul(x, y) == jc.sat_mul(x, y)


def test_deep_chain_saturates_without_growth(small_ctx):
    p = Pair(small_ctx, 3)
    (ja, ta) = p.ct([1, 1, 1])
    je, te = jc.lift(ja), tc.lift(ta)
    for _ in range(48):                 # 3^49 chunks: saturated, never materialized
        je, te = je * ja, te * ta
    assert te.chunks == je.chunks == tc.CHUNKS_SAT
    assert int(p.tsk.decrypt_circuit(te)) == int(p.jsk.decrypt_circuit(je)) == 1


def test_pack_fleet_bits_roundtrip():
    rng = np.random.default_rng(0)
    for b in (1, 7, 8, 9, 64, 300):
        bits = rng.integers(0, 2, b).astype(np.uint8)
        v = tc.pack_fleet_bits(bits)
        assert v == jc.pack_fleet_bits(bits)
        np.testing.assert_array_equal(tc.unpack_fleet_bits(v, b), jc.unpack_fleet_bits(v, b))
        np.testing.assert_array_equal(tc.unpack_fleet_bits(v, b), bits)


def test_fleet_dags_and_decrypt_batches_packed(small_ctx):
    p = Pair(small_ctx, 5)
    rng = p.rng
    (jx, tx) = p.batch(rng.integers(0, 2, (6, 3)))
    (jy, ty) = p.batch(rng.integers(0, 2, (6, 2)))
    (jz, tz) = p.batch(rng.integers(0, 2, (6, 3)))
    (js, ts) = p.ct([1])                                       # a scalar leaf
    je = (jc.lift(jx) * jy + jz) * jx + js
    te = (tc.lift(tx) * ty + tz) * tx + ts
    assert te.batch == je.batch == 6 and te.chunks == je.chunks
    tbits, jbits = p.tsk.decrypt_circuit(te), p.jsk.decrypt_circuit(je)
    np.testing.assert_array_equal(tbits, jbits)
    assert tbits.sum() > 0
    outs = p.tsk.decrypt_circuits([te, tc.lift(tx) * ty, tc.lift(ts) * ts])
    jouts = p.jsk.decrypt_circuits([je, jc.lift(jx) * jy, jc.lift(js) * js])
    np.testing.assert_array_equal(outs[0], jouts[0])
    np.testing.assert_array_equal(outs[1], jouts[1])
    assert int(outs[2]) == int(jouts[2]) == 1
    np.testing.assert_array_equal(outs[1], p.tsk.decrypt_batch(tx * ty).numpy())
    packed = p.tsk.decrypt_batches_packed([tx, ty, tz, tx])
    assert packed == p.jsk.decrypt_batches_packed([jx, jy, jz, jx])
    assert packed[0] == packed[3] == tc.pack_fleet_bits(p.tsk.decrypt_batch(tx).numpy())
    # An all-batch DAG materializes into a batch; bit-equal to JAX's.
    jm, tm = (jc.lift(jx) * jy + jz).materialize(), (tc.lift(tx) * ty + tz).materialize()
    np.testing.assert_array_equal(tm.to_u64(), jm.to_u64())
    assert isinstance(tm, T.CiphertextBatch)


def test_fleet_guards(small_ctx):
    p = Pair(small_ctx, 9)
    (jx, tx) = p.batch([[1, 0], [1, 1], [0, 0]])
    (jy, ty) = p.batch([[1], [0]])
    (js, ts) = p.ct([1])
    for lift, x, y in ((jc.lift, jx, jy), (tc.lift, tx, ty)):
        with pytest.raises(ValueError, match="fleet batch mismatch"):
            lift(x) * y
    for lift, x, s in ((jc.lift, jx, js), (tc.lift, tx, ts)):
        with pytest.raises(ValueError, match="cannot materialize a fleet DAG with scalar"):
            (lift(x) + s).materialize()
    other = T.SecretKey(T.Context(100, 4), [1, 2, 3, 4], device="cpu")
    with pytest.raises(ValueError, match="context mismatch"):
        other.decrypt_circuits([tc.lift(tx) * tx])
    with pytest.raises(ValueError, match="context mismatch"):
        other.decrypt_batches_packed([tx])
