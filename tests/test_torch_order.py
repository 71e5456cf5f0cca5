"""Lazy chunk order on the port against csgn_tpu on the CPU, bit-exactly.

Both packages are forced onto the same non-canonical multiply routes, as
tests/test_order.py forces the JAX one, by patching the ``*_auto`` dispatch
functions: "jmajor" (the canonical product of the swapped operands) and
"ragged" (j-major with a's chunks zero-padded to the ragged kernel's length,
the JAX package's `mul_chunks_pallas_tiled_ragged` in interpret mode; on the
port, zero chunks appended and the canonical product).  Through every
operator that carries a tag — ``+``, ``*``, `mul_and_decrypt(_batch)`,
`apply_permutation`, `permute_and_decrypt`, batch `stack` and
``__getitem__``, a serve flush, the pipeline chains, io and
`set_eager_order` — the physical words, ``logical``, ``pad``, ``chunks``,
the canonical words, ``to_u64()``, ``size()`` and the decrypts must be
equal.  Also: every `ops.order` function on random tags, the public names
against csgn_tpu's signatures, `mul_chunks_batched`'s 4-tuple, the card's
route rule as a pure function (the CPU always canonical), and a lazy JAX
ciphertext crossing through `convert`.  Keys, bits and words are made by
numpy from fixed seeds; the counter encrypt engine is bit-exact across the
packages.  Tolerance: 0 everywhere.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
import csgn_tpu.ciphertext as jct_mod
import csgn_tpu_torch as T
from csgn_tpu import io as jio
from csgn_tpu import pipeline as jpipe
from csgn_tpu.ops import dispatch as jdispatch
from csgn_tpu.ops import kernels as jkernels
from csgn_tpu.ops import order as jorder
from csgn_tpu.ops import permute_mxu as jmxu
from csgn_tpu_torch import convert
from csgn_tpu_torch import io as tio
from csgn_tpu_torch import pipeline as tpipe
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import dispatch, kernels, order
from csgn_tpu_torch.ops import permute_mxu as tmxu

CTX = (95, 4)


def _ctxs():
    return J.Context(*CTX), T.Context(*CTX)


def _rand_pair(rng, chunks, jctx, tctx, mask=None, cols=()):
    """The same random canonical words as a JAX and a port ciphertext; the
    key mask forced into `cols` (those chunks decrypt to 1)."""
    w = rng.integers(0, 2**32, (jctx.words32, chunks), dtype=np.uint32) & jctx.valid_mask[:, None]
    for c in cols:
        w[:, c] |= mask
    return J.Ciphertext(jnp.asarray(w), jctx), T.Ciphertext(words_from_numpy(w, "cpu"), tctx)


def _keys(seed):
    jctx, tctx = _ctxs()
    idx = np.random.default_rng(seed).choice(jctx.n, jctx.d, replace=False).astype(np.int32)
    return J.SecretKey(jctx, idx), convert.secret_key_from_numpy(tctx, idx, device="cpu")


def _tag(x):
    return None if x is None else np.asarray(x)


def _same(t, j):
    """Every observable of a port ciphertext (or batch) equals the JAX one's."""
    np.testing.assert_array_equal(words_to_numpy(t.wt), np.asarray(j.wt))
    if j.logical is None:
        assert t.logical is None
    else:
        np.testing.assert_array_equal(t.logical.numpy(), np.asarray(j.logical))
    assert (t.pad, t.chunks, t.physical_chunks, t.is_canonical) == \
        (j.pad, j.chunks, j.physical_chunks, j.is_canonical)
    np.testing.assert_array_equal(words_to_numpy(t.canonical().wt), np.asarray(j.canonical().wt))
    np.testing.assert_array_equal(t.to_u64(), j.to_u64())
    assert t.nbytes == j.nbytes
    if isinstance(t, T.Ciphertext):
        assert t.size() == j.size() and t.bitlen == j.bitlen


# ---------------------------------------------------------------------------
# Forced routes, both packages
# ---------------------------------------------------------------------------


def _jax_routes(route):
    if route == "jmajor":
        def mul(a, b):
            return jdispatch.mul_chunks_jmajor(a, b), True, 0, 0

        def mul_dec(a, b, m):
            out, p = jdispatch.mul_decrypt(b, a, m)
            return out, True, 0, 0, p

        def mul_b(a, b):
            return jdispatch.mul_chunks_jmajor(a, b), True, 0, 0

        def mul_dec_b(a, b, m):
            out, p = jdispatch.mul_decrypt_batched(b, a, m)
            return out, True, 0, 0, p
    else:
        def zp(a):
            return jkernels.ragged_padded(a.shape[-1]) - a.shape[-1]

        def mul(a, b):
            return jkernels.mul_chunks_pallas_tiled_ragged(b, a), True, zp(a), 0

        def mul_dec(a, b, m):
            out, p = jkernels.mul_decrypt_pallas_tiled_ragged(b, a, m)
            return out, True, zp(a), 0, p

        def mul_b(a, b):
            return jax.vmap(jkernels.mul_chunks_pallas_tiled_ragged)(b, a), True, zp(a), 0

        def mul_dec_b(a, b, m):
            out, p = jax.vmap(lambda x, y: jkernels.mul_decrypt_pallas_tiled_ragged(x, y, m))(b, a)
            return out, True, zp(a), 0, p
    return {"mul_chunks_auto": mul, "mul_decrypt_auto": mul_dec, "mul_chunks_batched": mul_b,
            "mul_decrypt_batched_auto": mul_dec_b}


def _port_routes(route):
    def zp(a):
        return jkernels.ragged_padded(a.shape[-1]) - a.shape[-1] if route == "ragged" else 0

    def mul(a, b):
        z = zp(a)
        return kernels.mul_chunks(b, torch.nn.functional.pad(a, (0, z))), True, z, 0

    def mul_dec(a, b, m):
        z = zp(a)
        out, p = kernels.mul_decrypt(b, torch.nn.functional.pad(a, (0, z)), m)
        return out, True, z, 0, p

    return {"mul_chunks_auto": mul, "mul_decrypt_auto": mul_dec, "mul_chunks_batched": mul,
            "mul_decrypt_batched_auto": mul_dec}


@pytest.fixture(params=["jmajor", "ragged"])
def route(request, monkeypatch):
    """Both packages' `*`, `mul_and_decrypt` and batched forms on one forced
    route (ciphertext.py, batch.py and secret_key.py call the dispatch
    modules' attributes, so the patch is seen)."""
    for name, fn in _jax_routes(request.param).items():
        monkeypatch.setattr(jdispatch, name, fn)
    for name, fn in _port_routes(request.param).items():
        monkeypatch.setattr(dispatch, name, fn)
    return request.param


# ---------------------------------------------------------------------------
# ops/order.py
# ---------------------------------------------------------------------------


def _rand_tag(rng, n, pads):
    """A random permutation of [0, n) with `pads` PAD entries mixed in."""
    tag = np.concatenate([rng.permutation(n), np.full(pads, -1)]).astype(np.int32)
    return rng.permutation(tag).astype(np.int32)


@pytest.mark.parametrize("fn", ["extend_with_pads", "concat_logical", "cross_logical",
                                "inverse_permutation", "canonicalize"])
def test_order_functions_match_jax(fn):
    rng = np.random.default_rng(sum(map(ord, fn)))
    tt = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    for trial in range(6):
        t1, t2 = (int(x) for x in rng.integers(1, 9, 2))
        la = _rand_tag(rng, t1, trial % 3) if trial % 2 else None
        lb = _rand_tag(rng, t2, trial % 2) if trial % 3 else None
        if fn == "extend_with_pads":
            for tag, n in ((la, t1), (lb, t2)):
                for zp in (0, 3):
                    want = jorder.extend_with_pads(None if tag is None else jnp.asarray(tag), n, zp)
                    got = order.extend_with_pads(tt(tag), n, zp, device="cpu")
                    assert (want is None) == (got is None)
                    if want is not None:
                        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        elif fn in ("concat_logical", "cross_logical"):
            n1 = t1 if la is None else int((la >= 0).sum())
            n2 = t2 if lb is None else int((lb >= 0).sum())
            ja, jb = (None if x is None else jnp.asarray(x) for x in (la, lb))
            for kw in ([{}] if fn == "concat_logical" else [{"jmajor": False}, {"jmajor": True}]):
                want = getattr(jorder, fn)(ja, jb, n1, n2, **kw)
                got = getattr(order, fn)(tt(la), tt(lb), n1, n2, device="cpu", **kw)
                assert (want is None) == (got is None)
                if want is not None:
                    assert got.dtype == torch.int32
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        elif fn == "inverse_permutation":
            perm = rng.permutation(int(rng.integers(1, 300))).astype(np.int32)
            got = order.inverse_permutation(torch.from_numpy(perm))
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                jorder.inverse_permutation(jnp.asarray(perm))))
            np.testing.assert_array_equal(perm[got.numpy()], np.arange(len(perm)))
        else:
            tag = _rand_tag(rng, t1 * t2, trial)
            words = rng.integers(0, 2**32, (2, 3, len(tag)), dtype=np.uint32)
            if trial == 5:
                tag[tag == 0] = 1    # corrupted: slot 0 never filled -> all-ones column
            want = jorder.canonicalize(jnp.asarray(words), jnp.asarray(tag), t1 * t2)
            got = order.canonicalize(words_from_numpy(words, "cpu"), torch.from_numpy(tag),
                                     t1 * t2)
            np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    assert order.PAD == jorder.PAD == -1


def _signature(fn):
    """Positional parameters and their defaults; the port's keyword-only
    ``device`` (where its tags are made) is not part of the JAX call."""
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()
            if p.name != "device"]


@pytest.mark.parametrize("mod", ["order", "permute_mxu", "dispatch"])
def test_public_names_match_jax(mod):
    """Every public name of csgn_tpu's `ops.order`, `ops.permute_mxu` and
    `dispatch.__all__` has a counterpart of the same call signature."""
    jmod, tmod = {"order": (jorder, order), "permute_mxu": (jmxu, tmxu),
                  "dispatch": (jdispatch, dispatch)}[mod]
    missing = sorted(set(jmod.__all__) - set(tmod.__all__))
    assert not missing, missing
    for name in jmod.__all__:
        j, t = getattr(jmod, name), getattr(tmod, name)
        if callable(j):
            assert _signature(t) == _signature(j), name
        else:
            assert t == j, name


def test_mul_chunks_batched_returns_jax_tuple():
    """`mul_chunks_batched` and the ``*_auto`` functions return the JAX
    package's tuples, element for element, on the CPU's canonical route."""
    jctx, _ = _ctxs()
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (3, jctx.words32, 5), dtype=np.uint32)
    b = rng.integers(0, 2**32, (3, jctx.words32, 7), dtype=np.uint32)
    mask = rng.integers(0, 2**32, jctx.words32, dtype=np.uint32)
    ta, tb, tm = (words_from_numpy(x, "cpu") for x in (a, b, mask))
    ja, jb, jm = jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)
    for got, want in ((dispatch.mul_chunks_batched(ta, tb), jdispatch.mul_chunks_batched(ja, jb)),
                      (dispatch.mul_chunks_auto(ta[0], tb[0]),
                       jdispatch.mul_chunks_auto(ja[0], jb[0])),
                      (dispatch.mul_decrypt_auto(ta[1], tb[1], tm),
                       jdispatch.mul_decrypt_auto(ja[1], jb[1], jm)),
                      (dispatch.mul_decrypt_batched_auto(ta, tb, tm),
                       jdispatch.mul_decrypt_batched_auto(ja, jb, jm))):
        assert len(got) == len(want) and tuple(got[1:4]) == tuple(want[1:4]) == (False, 0, 0)
        np.testing.assert_array_equal(words_to_numpy(got[0]), np.asarray(want[0]))
        if len(got) == 5:
            np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    jm_words = dispatch.mul_chunks_jmajor(ta[2], tb[2])
    np.testing.assert_array_equal(words_to_numpy(jm_words),
                                  np.asarray(jdispatch.mul_chunks_jmajor(ja[2], jb[2])))


@pytest.mark.parametrize("t1,t2", [(4, 3), (16, 1 << 10), (5, 7)])
def test_auto_routes_are_canonical_where_b_streams(monkeypatch, t1, t2):
    """The port's ``*_auto`` routes write the canonical order with no pads at
    every shape, also where b would stream (the shape the JAX package's TPU
    backend sends to its swapped kernels); only `mul_chunks_jmajor` writes
    the j-major order."""
    monkeypatch.setattr(kernels, "B_STREAM_BYTES", 4 * 2 * t2 - 1)   # b streams at W = 2
    assert kernels.mul_mode(2, t1, t2, True) == "tiled"
    rng = np.random.default_rng(t1 * t2)
    a = words_from_numpy(rng.integers(0, 2**32, (3, 2, t1), dtype=np.uint32), "cpu")
    b = words_from_numpy(rng.integers(0, 2**32, (3, 2, t2), dtype=np.uint32), "cpu")
    m = words_from_numpy(rng.integers(0, 2**32, (2,), dtype=np.uint32), "cpu")
    want = kernels.mul_chunks_plain(a, b)
    for got in (dispatch.mul_chunks_auto(a[0], b[0]), dispatch.mul_decrypt_auto(a[0], b[0], m)):
        assert tuple(got[1:4]) == (False, 0, 0) and torch.equal(got[0], want[0])
    for got in (dispatch.mul_chunks_batched(a, b), dispatch.mul_decrypt_batched_auto(a, b, m)):
        assert tuple(got[1:4]) == (False, 0, 0) and torch.equal(got[0], want)
    jm = dispatch.mul_chunks_jmajor(a[0], b[0])
    tag = order.cross_logical(None, None, t1, t2, jmajor=True, device="cpu")
    assert torch.equal(order.canonicalize(jm, tag), want[0])


# ---------------------------------------------------------------------------
# Tagged state through every operator, on the forced routes
# ---------------------------------------------------------------------------


def test_operators_match_jax(route):
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(10)
    (ja, ta), (jb, tb), (jc, tc), (jd, td) = (_rand_pair(rng, k, jctx, tctx) for k in (5, 3, 4, 2))
    jp, tp = ja * jb, ta * tb
    assert not tp.is_canonical and (tp.pad > 0) == (route == "ragged")
    _same(tp, jp)
    _same(tp + tc, jp + jc)                       # tag + canonical
    _same(tc + tp, jc + jp)                       # canonical + tag
    _same((tp + tc) * td, (jp + jc) * jd)         # tagged operand of a product
    _same(td * (tp + tc), jd * (jp + jc))
    _same(tp * tp, jp * jp)                       # both tagged
    perm = np.random.default_rng(11).permutation(jctx.n).astype(np.int32)
    _same(tp.apply_permutation(T.Permutation(perm)), jp.apply_permutation(J.Permutation(perm)))
    # a random circuit of + and *, as tests/test_order.py drives the JAX one
    cts = [_rand_pair(rng, int(c), jctx, tctx) for c in rng.integers(1, 5, size=6)]
    jg, tg = cts[0]
    for i, (jx, tx) in enumerate(cts[1:]):
        jg, tg = (jg + jx, tg + tx) if i % 2 == 0 else (jg * jx, tg * tx)
        _same(tg, jg)
    assert "lazy" in repr(tp) and "canonical" in repr(tc)


def test_tag_checks_match_jax():
    jctx, tctx = _ctxs()
    _, t = _rand_pair(np.random.default_rng(12), 4, jctx, tctx)
    with pytest.raises(ValueError, match="order tag"):
        T.Ciphertext(t.wt, tctx, None, 1)
    with pytest.raises(ValueError, match="order tag shape"):
        T.Ciphertext(t.wt, tctx, torch.arange(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        T.Ciphertext(t.wt, tctx, torch.arange(4))
    with pytest.raises(ValueError, match="order tag"):
        T.CiphertextBatch(t.wt[None], tctx, None, 2)


def test_decrypts_match_jax(route):
    """`decrypt`, `mul_and_decrypt`, `decrypt_batch`, `mul_and_decrypt_batch`
    and `permute_and_decrypt` on tagged and padded payloads."""
    jsk, tsk = _keys(20)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(21)
    pairs = [_rand_pair(rng, k, jctx, tctx, jsk.mask, cols) for k, cols in
             ((3, (0, 2)), (5, (1,)), (2, (0, 1)), (3, ()))]
    (ja, ta), (jb, tb), (jc, tc), (jd, td) = pairs
    for (jx, tx), (jy, ty) in (((ja, ta), (jb, tb)), ((jb, tb), (jc, tc)), ((ja, ta), (jd, td))):
        jp, jbit = jsk.mul_and_decrypt(jx, jy)
        tp, tbit = tsk.mul_and_decrypt(tx, ty)
        _same(tp, jp)
        _same(tp, jx * jy)
        assert int(tbit) == int(jbit) == int(tsk.decrypt(tx * ty)) == int(jsk.decrypt(jx * jy))
        # a tagged operand of the fused product
        jq, jbit2 = jsk.mul_and_decrypt(jp + jc, jy)
        tq, tbit2 = tsk.mul_and_decrypt(tp + tc, ty)
        _same(tq, jq)
        assert int(tbit2) == int(jbit2) == int(tsk.decrypt(tq.canonical()))
        perm = rng.permutation(jctx.n).astype(np.int32)
        jr, jrb = jsk.permute_and_decrypt(jp, J.Permutation(perm))
        tr, trb = tsk.permute_and_decrypt(tp, T.Permutation(perm))
        _same(tr, jr)
        assert int(trb) == int(jrb) == int(tbit)
    jba, jbb = J.CiphertextBatch.stack([ja, jd]), J.CiphertextBatch.stack([jb * jc, jc * jb])
    tba, tbb = T.CiphertextBatch.stack([ta, td]), T.CiphertextBatch.stack([tb * tc, tc * tb])
    _same(tba, jba)
    jprod, jbits = jsk.mul_and_decrypt_batch(jba, jbb)
    tprod, tbits = tsk.mul_and_decrypt_batch(tba, tbb)
    _same(tprod, jprod)
    _same(tba * tbb, jba * jbb)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tsk.decrypt_batch(tprod).numpy(),
                                  np.asarray(jsk.decrypt_batch(jprod)))
    for i in range(2):
        _same(tprod[i], jprod[i])
        assert tprod[i].logical is tprod.logical
        assert int(tsk.decrypt(tprod[i])) == int(jbits[i])


def test_batch_stack_getitem_and_permute(route):
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(30)
    (ja, ta), (jb, tb), (jc, tc) = (_rand_pair(rng, k, jctx, tctx) for k in (3, 4, 2))
    jbatch = J.CiphertextBatch.stack([ja, ja]) * J.CiphertextBatch.stack([jb, jc + jc])
    tbatch = T.CiphertextBatch.stack([ta, ta]) * T.CiphertextBatch.stack([tb, tc + tc])
    _same(tbatch, jbatch)
    for i in range(2):
        _same(tbatch[i], jbatch[i])
    _same(tbatch + tbatch, jbatch + jbatch)
    perms = [rng.permutation(jctx.n).astype(np.int32) for _ in range(2)]
    _same(tbatch.apply_permutation(T.Permutation(perms[0])),
          jbatch.apply_permutation(J.Permutation(perms[0])))
    _same(tbatch.apply_permutations([T.Permutation(p) for p in perms]),
          jbatch.apply_permutations([J.Permutation(p) for p in perms]))
    restacked = T.CiphertextBatch.stack([tbatch[0], tbatch[1]])   # canonicalizes each
    _same(restacked, J.CiphertextBatch.stack([jbatch[0], jbatch[1]]))
    assert restacked.is_canonical


def test_serve_flush_matches_jax(route):
    """A flush of tagged requests: all-canonical groups stack raw, one shared
    tag stays shared, mixed tags canonicalize (csgn_tpu/serve.py:80-95)."""
    jsk, tsk = _keys(40)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(41)
    (ja, ta), (jb, tb), (jc, tc), (jd, td) = (_rand_pair(rng, k, jctx, tctx, jsk.mask, (0,))
                                              for k in (3, 2, 6, 3))
    jlazy, tlazy = ja * jb, ta * tb
    jbat = J.CiphertextBatch.stack([ja, jd]) * J.CiphertextBatch.stack([jb, jb])
    tbat = T.CiphertextBatch.stack([ta, td]) * T.CiphertextBatch.stack([tb, tb])
    jex, tex = J.BatchExecutor(jsk), T.BatchExecutor(tsk, rng=T.rng.key(0))
    # Distinct b chunk counts keep the three groups apart.
    groups = [[(jlazy, jc), (jlazy.canonical(), jc)],          # mixed tags
              [(jbat[0], jb), (jbat[1], jb)],                  # one shared tag
              [(jc, jd), (jc, jd)]]                            # all canonical
    tgroups = [[(tlazy, tc), (tlazy.canonical(), tc)], [(tbat[0], tb), (tbat[1], tb)],
               [(tc, td), (tc, td)]]
    jf, tf = [], []
    for jg, tg in zip(groups, tgroups):
        for kind in ("submit_mul", "submit_add", "submit_mul_decrypt"):
            jf += [getattr(jex, kind)(x, y) for x, y in jg]
            tf += [getattr(tex, kind)(x, y) for x, y in tg]
        jf += [jex.submit_decrypt(x) for x, _ in jg]
        tf += [tex.submit_decrypt(x) for x, _ in tg]
    perm = rng.permutation(jctx.n).astype(np.int32)
    jf.append(jex.submit_permute(jlazy, J.Permutation(perm)))
    tf.append(tex.submit_permute(tlazy, T.Permutation(perm)))
    jex.flush()
    tex.flush()
    assert tex.stats["group_dispatches"] == jex.stats["group_dispatches"]
    for j, t in zip(jf, tf):
        jv, tv = j.result(), t.result()
        if isinstance(jv, tuple):
            _same(tv[0], jv[0])
            assert int(tv[1]) == int(jv[1])
        elif isinstance(jv, J.Ciphertext):
            _same(tv, jv)
        else:
            assert int(tv) == int(jv)


def test_pipeline_chains_match_jax(route):
    jsk, tsk = _keys(50)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(51)
    (ja, ta), (jb, tb), (jc, tc) = (_rand_pair(rng, k, jctx, tctx, jsk.mask, (0,))
                                    for k in (3, 5, 2))
    jl, tl = ja * jb, ta * tb
    for jcts, tcts in (([jl, jc, jl], [tl, tc, tl]), ([jc, jl], [tc, tl]), ([jl], [tl])):
        _same(tpipe.mul_chain(tcts), jpipe.mul_chain(jcts))
        jw, jbit = jpipe.mul_chain_decrypt(jcts, jsk)
        tw, tbit = tpipe.mul_chain_decrypt(tcts, tsk)
        _same(tw, jw)
        assert int(tbit) == int(jbit)


def test_io_round_trip_and_sharded_refusal(route, tmp_path):
    """Single-file saves write canonical words (the JAX file's); both
    packages' sharded saves refuse a lazy payload."""
    jsk, tsk = _keys(60)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(61)
    (ja, ta), (jb, tb) = (_rand_pair(rng, k, jctx, tctx) for k in (3, 5))
    jl, tl = ja * jb + ja, ta * tb + ta
    jio.save_ciphertext(tmp_path / "j.npz", jl)
    tio.save_ciphertext(tmp_path / "t.npz", tl)
    tio.save_state(tmp_path / "ts.npz", {"ct": tl, "sk": tsk})
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        np.testing.assert_array_equal(tz["words"], jz["words"])
    back = tio.load_ciphertext(tmp_path / "j.npz", device="cpu")
    assert back.is_canonical
    np.testing.assert_array_equal(back.to_u64(), jl.to_u64())
    state = tio.load_state(tmp_path / "ts.npz", device="cpu")
    np.testing.assert_array_equal(state["ct"].to_u64(), jl.to_u64())
    np.testing.assert_array_equal(jio.load_state(tmp_path / "ts.npz")["ct"].to_u64(),
                                  jl.to_u64())
    for save, ct in ((jio.save_state_sharded, jl), (tio.save_state_sharded, tl)):
        with pytest.raises(ValueError, match="canonical payload"):
            save(tmp_path / "shards", {"ct": ct})
    tio.save_state_sharded(tmp_path / "shards", {"ct": tl.canonical()})
    np.testing.assert_array_equal(
        tio.load_state_sharded(tmp_path / "shards", device="cpu")["ct"].to_u64(), jl.to_u64())


def test_eager_order_matches_jax(route):
    """`set_eager_order(True)` makes every product canonical in both
    packages, with the lazy results' bytes (the serialization parity check
    of the verify notes)."""
    jsk, tsk = _keys(70)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(71)
    (ja, ta), (jb, tb), (jc, tc) = (_rand_pair(rng, k, jctx, tctx, jsk.mask, (1,))
                                    for k in (3, 2, 5))
    jlazy, tlazy = (ja * jb + jc) * jb, (ta * tb + tc) * tb
    jmd, tmd = jsk.mul_and_decrypt(ja * jb, jc), tsk.mul_and_decrypt(ta * tb, tc)
    jprev, tprev = J.set_eager_order(True), T.set_eager_order(True)
    try:
        assert jprev is False and tprev is False and jct_mod._EAGER_ORDER
        jeager, teager = (ja * jb + jc) * jb, (ta * tb + tc) * tb
        jmde, tmde = jsk.mul_and_decrypt(ja * jb, jc), tsk.mul_and_decrypt(ta * tb, tc)
    finally:
        assert J.set_eager_order(jprev) is True and T.set_eager_order(tprev) is True
    assert teager.is_canonical and teager.pad == 0
    _same(teager, jeager)
    _same(tmde[0], jmde[0])
    assert tmde[0].is_canonical and int(tmde[1]) == int(jmde[1]) == int(tmd[1])
    np.testing.assert_array_equal(tlazy.to_u64(), teager.to_u64())
    np.testing.assert_array_equal(tmd[0].to_u64(), tmde[0].to_u64())
    _same(tlazy, jlazy)


def test_lazy_jax_ciphertext_crosses_convert(route):
    """The JAX j-major 5 x 3 product (and a padded one) crosses with its tag
    and pad: `is_canonical`, `to_u64()` and the decrypt are JAX's."""
    jsk, tsk = _keys(80)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(81)
    (ja, _), (jb, _) = (_rand_pair(rng, k, jctx, tctx, jsk.mask, (0, 1)) for k in (5, 3))
    for jct in (ja * jb, (ja * jb + ja) * jb):
        tct = convert.ciphertext_from_numpy(np.asarray(jct.wt), tctx, "cpu",
                                            logical=_tag(jct.logical), pad=jct.pad)
        assert not tct.is_canonical
        _same(tct, jct)
        assert int(tsk.decrypt(tct)) == int(jsk.decrypt(jct))
    jbat = J.CiphertextBatch.stack([ja, ja]) * J.CiphertextBatch.stack([jb, jb])
    tbat = convert.ciphertext_batch_from_numpy(np.asarray(jbat.wt), tctx, "cpu",
                                               logical=_tag(jbat.logical), pad=jbat.pad)
    _same(tbat, jbat)
