"""The port's serving executor against csgn_tpu.serve: grouping (one group
launch per compatible group), `max_batch`, futures that flush on
`result()`, `stats`; every route bit-equal to the JAX `BatchExecutor` given
the same input ciphertexts; serve-encrypts by decryption and determinism
(the JAX executor's default-engine randomness is not reproducible in the
port, so its words are not compared); and the two faults the port repairs.
Tolerance: 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu.circuit import lift as jlift
from csgn_tpu.models import netlist as jn
from csgn_tpu_torch import convert, serve
from csgn_tpu_torch.circuit import lift as tlift
from csgn_tpu_torch.models import netlist as tn


class Fleet:
    """A key in both packages and a source of paired ciphertexts."""

    def __init__(self, ctx, seed=1):
        rng = np.random.default_rng(seed)
        idx = rng.choice(ctx.n, ctx.d, replace=False).astype(np.int32)
        self.ctx, self.tctx = ctx, T.Context(ctx.n, ctx.d)
        self.jsk = J.SecretKey(ctx, idx)
        self.tsk = convert.secret_key_from_numpy(self.tctx, idx, device="cpu")
        self.rng = rng
        self.seed = seed

    def ct(self, chunks, bit=None):
        bits = self.rng.integers(0, 2, chunks).astype(np.uint8)
        if bit is not None:
            bits[0] ^= int(bits.sum() % 2 != bit)
        self.seed += 1
        w = np.asarray(self.jsk.encrypt_batch(jnp.asarray(bits), self.seed, engine="counter"))
        return (J.Ciphertext(jnp.asarray(w), self.ctx),
                convert.ciphertext_from_numpy(w, self.tctx, "cpu"))

    def executors(self, **kw):
        return (J.BatchExecutor(self.jsk, rng=jax.random.key(9), **kw),
                T.BatchExecutor(self.tsk, seed=9, **kw))


@pytest.fixture
def fleet(small_ctx):
    return Fleet(small_ctx)


def _u64(x):
    return x.to_u64()


def test_ciphertext_routes_match_jax(fleet):
    jex, tex = fleet.executors()
    pairs = [(fleet.ct(2), fleet.ct(3)) for _ in range(5)] + [(fleet.ct(1), fleet.ct(1))] * 2
    futs = {"j": [], "t": []}
    for (ja, ta), (jb, tb) in pairs:
        for side, ex, a, b in (("j", jex, ja, jb), ("t", tex, ta, tb)):
            futs[side].append((ex.submit_add(a, b), ex.submit_mul(a, b),
                               ex.submit_mul_decrypt(a, b), ex.submit_decrypt(a)))
    assert tex.pending() == jex.pending() == 28
    tex.flush()
    jex.flush()
    # (add, mul, muldec, dec) x two shape classes (2x3 and 1x1).
    assert tex.stats == jex.stats == {"requests": 28, "flushes": 1, "group_dispatches": 8}
    for jf, tf in zip(futs["j"], futs["t"]):
        np.testing.assert_array_equal(_u64(tf[0].result()), _u64(jf[0].result()))
        np.testing.assert_array_equal(_u64(tf[1].result()), _u64(jf[1].result()))
        (tp, tbit), (jp, jbit) = tf[2].result(), jf[2].result()
        np.testing.assert_array_equal(_u64(tp), _u64(jp))
        assert tbit == int(jbit) and tf[3].result() == jf[3].result()
    assert {f[2].result()[1] for f in futs["t"]} == {0, 1}


def test_permute_and_circuit_routes_match_jax(fleet):
    jex, tex = fleet.executors()
    cts = [fleet.ct(3, bit=int(k < 2)) for k in range(4)]
    perms = [fleet.rng.permutation(fleet.ctx.n) for _ in range(4)]
    jp = [jex.submit_permute(j, J.Permutation(p)) for (j, _), p in zip(cts, perms)]
    tp = [tex.submit_permute(t, convert.permutation_from_numpy(p)) for (_, t), p in zip(cts, perms)]
    (ja, ta), (jb, tb), (jc, tcc) = cts[:3]
    jbatch, tbatch = fleet_batch(fleet, 5)
    jexprs = [jlift(ja) * jb + jc, ja, jlift(jbatch) * jbatch + ja]
    texprs = [tlift(ta) * tb + tcc, ta, tlift(tbatch) * tbatch + ta]
    jd = [jex.submit_decrypt_circuit(e) for e in jexprs]
    td = [tex.submit_decrypt_circuit(e) for e in texprs]
    for f, g in zip(tp, jp):
        np.testing.assert_array_equal(_u64(f.result()), _u64(g.result()))   # flushes all
    assert tex.stats["group_dispatches"] == jex.stats["group_dispatches"] == 2
    assert [td[0].result(), td[1].result()] == [jd[0].result(), jd[1].result()]
    np.testing.assert_array_equal(td[2].result(), jd[2].result())
    assert td[1].result() == 1 and td[0].result() == (1 & 1) ^ 0


def fleet_batch(fleet, b):
    ws = [fleet.ct(2) for _ in range(b)]
    return (J.CiphertextBatch(jnp.stack([j.wt for j, _ in ws]), fleet.ctx),
            T.CiphertextBatch.stack([t for _, t in ws]))


def test_netlist_routes_match_jax(fleet):
    """adder(3) has no INV or EQ gate, so the materialized route never reads
    the NOT-constant: its words are held to JAX's.  comparator_gt(3) goes
    through the key-side route."""
    jex, tex = fleet.executors()
    rng = np.random.default_rng(3)
    add_t, add_j = tn.adder(3), jn.adder(3)
    gt_t, gt_j = tn.comparator_gt(3), jn.comparator_gt(3)
    vals = rng.integers(0, 8, (6, 2))
    vals[0] = [5, 3]
    futs = []
    for a, b in vals:
        bits = [[(a >> k) & 1 for k in range(3)], [(b >> k) & 1 for k in range(3)]]
        cts = [[fleet.ct(1, bit=x) for x in v] for v in bits]
        jin = [[j for j, _ in v] for v in cts]
        tin = [[t for _, t in v] for v in cts]
        futs.append((bits, jex.submit_netlist(add_j, jin), tex.submit_netlist(add_t, tin),
                     jex.submit_netlist_expr(gt_j, jin), tex.submit_netlist_expr(gt_t, tin)))
    tex.flush()
    jex.flush()
    assert tex.stats["group_dispatches"] == jex.stats["group_dispatches"] == 2
    for bits, jf, tf, jg, tg in futs:
        (tout,), (jout,) = tf.result(), jf.result()
        for t, j in zip(tout, jout):
            np.testing.assert_array_equal(_u64(t), _u64(j))
        assert [int(fleet.tsk.decrypt(c)) for c in tout] == tn.eval_plain(add_t, bits)[0]
        assert tg.result() == jg.result() == tn.eval_plain(gt_t, bits)
    assert futs[0][4].result() == [[1]]


def test_encrypt_route_decrypts_and_reproduces(fleet):
    bits = [1, 0, 1, 1, 0, 0, 1]
    runs = []
    for _ in range(2):
        ex = T.BatchExecutor(fleet.tsk, seed=5)
        futs = [ex.submit_encrypt(b) for b in bits]
        assert ex.pending() == 7 and not futs[0].done
        cts = [f.result() for f in futs]                  # result() flushes
        assert ex.pending() == 0 and futs[0].done
        dec = [ex.submit_decrypt(ct) for ct in cts]
        ex.flush()
        assert [f.result() for f in dec] == bits
        assert ex.stats == {"requests": 14, "flushes": 2, "group_dispatches": 2}
        runs.append([ct.to_u64() for ct in cts])
        ex.submit_encrypt(1)
        second = ex.submit_encrypt(1).result()            # the next flush: a new seed
        assert not np.array_equal(second.to_u64(), cts[0].to_u64())
    for x, y in zip(*runs):
        np.testing.assert_array_equal(x, y)
    other = T.BatchExecutor(fleet.tsk, seed=6).submit_encrypt(1).result()
    assert not np.array_equal(other.to_u64(), runs[0][0])
    assert serve.flush_seed(5, serve.ENCRYPT_STREAM, 0) != serve.flush_seed(
        5, serve.NETLIST_STREAM, 0)


def test_max_batch_and_grouping(fleet):
    tex = T.BatchExecutor(fleet.tsk, seed=1, max_batch=3)
    a = [fleet.ct(1)[1] for _ in range(4)]
    grown = a[0] + a[1]
    f1 = [tex.submit_mul(x, y) for x, y in zip(a, a[1:])]     # third submit flushes
    assert tex.stats["group_dispatches"] == 1 and all(f.done for f in f1)
    f2 = tex.submit_mul(grown, a[2])
    f3 = tex.submit_mul(a[0], a[3])
    assert tex.pending() == 2
    tex.flush()
    assert tex.stats["group_dispatches"] == 3                 # (1,1) and (2,1) groups
    assert f2.result().chunks == 2 and f3.result().chunks == 1
    with pytest.raises(ValueError, match="need a BatchExecutor"):
        T.BatchExecutor().submit_decrypt(a[0])
    with pytest.raises(TypeError):
        tex.submit_decrypt(grown.wt)
    with pytest.raises(ValueError, match="context differs"):
        tex.submit_decrypt(T.SecretKey(T.Context(100, 4), [1, 2, 3, 4], device="cpu").encrypt(1, 1))


def test_leaf_context_error_fails_only_its_request(fleet):
    """Repaired in the port: a circuit whose checked leaf is under the key's
    context but another leaf is not fails at flush; the JAX executor fails
    its whole group, the port only that request."""
    jex, tex = fleet.executors()
    other = J.Context(100, 4)
    ow = np.asarray(J.SecretKey(other, np.arange(4, dtype=np.int32)).encrypt_batch(
        jnp.asarray([1], dtype=jnp.uint8), 1, engine="counter"))
    jo = J.Ciphertext(jnp.asarray(ow), other)
    to = convert.ciphertext_from_numpy(ow, T.Context(100, 4), device="cpu")
    (ja, ta), (jb, tb) = fleet.ct(2, bit=1), fleet.ct(1, bit=1)
    jf = [jex.submit_decrypt_circuit(jlift(ja) * jb), jex.submit_decrypt_circuit(jlift(ja) + jo)]
    tf = [tex.submit_decrypt_circuit(tlift(ta) * tb), tex.submit_decrypt_circuit(tlift(ta) + to)]
    jex.flush()
    tex.flush()
    with pytest.raises(ValueError, match="context mismatch"):
        jf[0].result()                       # the JAX executor fails the good request too
    assert tf[0].result() == 1
    with pytest.raises(ValueError, match="leaf context differs"):
        tf[1].result()


def test_netlist_budget_refusal_names_both_knobs(fleet):
    """Repaired in the port: the executor's refusal names both knobs."""
    jex, tex = fleet.executors(netlist_budget_bytes=64)
    add_t, add_j = tn.adder(4), jn.adder(4)
    cts = [[fleet.ct(1, bit=1) for _ in range(4)] for _ in range(2)]
    jf = jex.submit_netlist(add_j, [[j for j, _ in v] for v in cts])
    tf = tex.submit_netlist(add_t, [[t for _, t in v] for v in cts])
    with pytest.raises(ValueError, match="budget") as jerr:
        jf.result()
    with pytest.raises(ValueError, match="budget") as terr:
        tf.result()
    assert "netlist_budget_bytes" not in str(jerr.value)
    assert "BatchExecutor(netlist_budget_bytes=...)" in str(terr.value)
    assert T.BatchExecutor(fleet.tsk)._netlist_budget == J.BatchExecutor(fleet.jsk)._netlist_budget
