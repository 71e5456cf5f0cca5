"""The port's permutation slice on the CPU against csgn_tpu, bit-exactly.

Plans are compared field by field with `csgn_tpu.ops.permute_benes`; the
plain versions of K8/K9/K12 against the Pallas kernels run as
tests/test_benes.py runs them (interpret mode on the CPU, ``block_c=128``)
and against the gather oracle; the Permutation algebra, the key transform
and `permute_and_decrypt` against csgn_tpu's; and the golden permutation
vectors dumped from the C++ reference (tests/golden/golden_vectors.json),
from their arrays (the rand() replay of the generation stays with the JAX
package's refcompat).  Tolerance: 0 everywhere.
"""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import layout as jl
from csgn_tpu.ops import permute_benes as jpb
from csgn_tpu_torch import convert
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import benes_kernels, dispatch
from csgn_tpu_torch.ops import core as tcore
from csgn_tpu_torch.ops import permute_benes as tpb

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden_vectors.json"
SCENARIOS = json.loads(GOLDEN.read_text())["scenarios"]
NS = [20, 100, 1247]


def _words(rng, n, lead, chunks):
    """Random canonical uint32 words [*lead, W, chunks] for n-bit chunks."""
    ctx = J.Context(n, 3)
    w = rng.integers(0, 2**32, size=(*lead, ctx.words32, chunks), dtype=np.uint32)
    return w & ctx.valid_mask[:, None]


def _structured(kind, n):
    perm = np.arange(n)
    if kind == "transposition":
        perm[3], perm[n - 7] = perm[n - 7], perm[3]
    return perm


def _assert_plans_equal(tplan, jplan):
    for f in dataclasses.fields(jplan):
        got, want = getattr(tplan, f.name), getattr(jplan, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name
    assert tplan.words_pad == jplan.words_pad


@pytest.mark.parametrize("kind", ["random", "identity", "transposition"])
@pytest.mark.parametrize("n", NS)
def test_plans_equal_jax(n, kind):
    rng = np.random.default_rng(n)
    perms = [_structured(kind, n) if kind != "random" else rng.permutation(n)
             for _ in range(3)]
    tplans = [tpb.build_plan(p, n) for p in perms]
    jplans = [jpb.build_plan(p, n) for p in perms]
    for tp, jp in zip(tplans, jplans):
        _assert_plans_equal(tp, jp)
        assert tpb._plan_static(tp, 40) == jpb._plan_static(jp, 40)
    tst, jst = tpb.stack_plans(tplans), jpb.stack_plans(jplans)
    _assert_plans_equal(tst, jst)
    assert tst.k == jst.k == 3
    assert tpb._plan_static(tst, 2) == jpb._plan_static(jst, 2)
    if kind == "identity":
        assert not tplans[0].masks.any()


def test_device_operands_cached_per_device():
    plan = T.Permutation.random(1247, torch.Generator().manual_seed(1)).benes_plan()
    masks, sched = tpb.device_operands(plan, "cpu")
    assert tpb.device_operands(plan, torch.device("cpu"))[0] is masks
    np.testing.assert_array_equal(masks.numpy().view(np.uint32), plan.masks)
    assert sched.shape == (len(plan.deltas), 2)
    assert sched[:, 0].tolist() == list(plan.deltas)


@pytest.mark.parametrize("chunks", [1, 129, 300])
@pytest.mark.parametrize("n", NS)
def test_k8_plain_matches_pallas(n, chunks):
    rng = np.random.default_rng(n * 1000 + chunks)
    perm = rng.permutation(n).astype(np.int32)
    x = _words(rng, n, (), chunks)
    jx = jnp.asarray(x)
    want = np.asarray(jpb.apply_benes_pallas(jx, jpb.build_plan(perm, n), block_c=128))

    plan, tx = tpb.build_plan(perm, n), words_from_numpy(x, device="cpu")
    np.testing.assert_array_equal(words_to_numpy(benes_kernels.apply_benes(tx, plan)), want)
    np.testing.assert_array_equal(words_to_numpy(dispatch.permute(tx, plan)), want)
    np.testing.assert_array_equal(
        words_to_numpy(tcore.permute_chunks(tx, torch.from_numpy(perm), n)), want)


@pytest.mark.parametrize("k,chunks", [(1, 129), (3, 1), (3, 300)])
@pytest.mark.parametrize("n", NS)
def test_k9_plain_matches_pallas(n, k, chunks):
    rng = np.random.default_rng(n + 10 * k + chunks)
    perms = [rng.permutation(n) for _ in range(k)]
    x = _words(rng, n, (k,), chunks)
    jst = jpb.stack_plans([jpb.build_plan(p, n) for p in perms])
    want = np.asarray(jpb.apply_benes_batch_pallas(jnp.asarray(x), jst, block_c=128))

    tst, tx = tpb.stack_plans([tpb.build_plan(p, n) for p in perms]), words_from_numpy(x, "cpu")
    np.testing.assert_array_equal(words_to_numpy(benes_kernels.apply_benes_batch(tx, tst)), want)
    np.testing.assert_array_equal(words_to_numpy(dispatch.permute_batched_multi(tx, tst)), want)
    # One plan for every element (permute_batched) == element by element.
    plan0 = tpb.build_plan(perms[0], n)
    got = words_to_numpy(dispatch.permute_batched(tx, plan0))
    for i in range(k):
        np.testing.assert_array_equal(
            got[i], words_to_numpy(benes_kernels.apply_benes(tx[i], plan0)))


def _forced_output_matches(rng, x, perm, mask, n, count):
    """OR into `count` columns of x the mask permuted back through π⁻¹, so
    those columns match `mask` after π."""
    inv = torch.from_numpy(np.argsort(perm))
    pre = words_to_numpy(tcore.permute_chunks(words_from_numpy(mask[:, None], "cpu"), inv, n))
    x[:, rng.choice(x.shape[1], count, replace=False)] |= pre[:, 0:1]


@pytest.mark.parametrize("chunks,forced", [(1, 1), (129, 7), (300, 0)])
@pytest.mark.parametrize("n", NS)
def test_k12_plain_matches_pallas(n, chunks, forced):
    rng = np.random.default_rng(n * 7 + chunks)
    perm = rng.permutation(n).astype(np.int32)
    # d = 16 (10 at n = 20): random chunks match by chance with odds 2^-d
    mask = jl.bit_positions_to_mask(rng.choice(n, min(16, n // 2), replace=False), n)
    x = _words(rng, n, (), chunks)
    if forced:
        _forced_output_matches(rng, x, perm, mask, n, forced)
    jplan = jpb.build_plan(perm, n)
    jout, jpar = jpb.apply_benes_decrypt_pallas(jnp.asarray(x), jplan, jnp.asarray(mask),
                                                block_c=128)
    _, jcnt = jpb.apply_benes_decrypt_pallas(jnp.asarray(x), jplan, jnp.asarray(mask),
                                             block_c=128, return_count=True)

    plan = tpb.build_plan(perm, n)
    tx, tm = words_from_numpy(x, "cpu"), words_from_numpy(mask, "cpu")
    out, par = benes_kernels.apply_benes_decrypt(tx, plan, tm)
    _, cnt = benes_kernels.apply_benes_decrypt(tx, plan, tm, return_count=True)
    np.testing.assert_array_equal(words_to_numpy(out), np.asarray(jout))
    assert (int(par), int(cnt)) == (int(jpar), int(jcnt))
    assert int(cnt) >= forced
    if forced:
        assert int(par) == forced & 1
    out2, par2 = dispatch.permute_decrypt(tx, plan, tm)   # staged K8 + K3
    assert torch.equal(out2, out) and int(par2) == int(par)


@pytest.mark.parametrize("kind", ["identity", "transposition"])
def test_zero_stage_plans(ctx, kind):
    """Plans with all-zero stages (skipped) stay exact, including a stack
    where only one plan has a stage off."""
    n = ctx.n
    perm = _structured(kind, n)
    rng = np.random.default_rng(11)
    x = _words(rng, n, (), 256)
    jplan, plan = jpb.build_plan(perm, n), tpb.build_plan(perm, n)
    assert (~plan.masks.any(axis=1)).sum() > 0
    want = np.asarray(jpb.apply_benes_pallas(jnp.asarray(x), jplan, block_c=128))
    got = benes_kernels.apply_benes(words_from_numpy(x, "cpu"), plan)
    np.testing.assert_array_equal(words_to_numpy(got), want)
    rnd = rng.permutation(n)
    jst = jpb.stack_plans([jplan, jpb.build_plan(rnd, n)])
    tst = tpb.stack_plans([plan, tpb.build_plan(rnd, n)])
    xb = np.stack([x, x])
    np.testing.assert_array_equal(
        words_to_numpy(benes_kernels.apply_benes_batch(words_from_numpy(xb, device="cpu"), tst)),
        np.asarray(jpb.apply_benes_batch_pallas(jnp.asarray(xb), jst, block_c=128)))


def test_right_shift_is_logical():
    """Every bit set: an arithmetic >> would smear the sign bit into the
    words; a permutation keeps exactly n ones per chunk."""
    n = 100
    ctx = T.Context(n, 4)
    x = torch.from_numpy(np.tile(ctx.valid_mask.view(np.int32)[:, None], (1, 3)))
    for seed in range(4):
        p = T.Permutation.random(n, torch.Generator().manual_seed(seed))
        got = benes_kernels.apply_benes(x, p.benes_plan())
        assert torch.equal(got, x)  # all ones permute to all ones
    single = torch.zeros_like(x)
    single[0] = -(2**31)  # bit 0 only: the sign bit of word 0
    p = T.Permutation(np.roll(np.arange(n), 1))  # out bit i = in bit i-1
    out = benes_kernels.apply_benes(single, p.benes_plan())
    assert out[0, 0] == 1 << 30 and int(out.count_nonzero()) == 3


def test_permutation_algebra_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.permutation(1247), rng.permutation(1247)
    tp, tq = convert.permutation_from_numpy(a), T.Permutation(b)
    jp, jq = J.Permutation(a), J.Permutation(b)
    np.testing.assert_array_equal((tp + tq).perm, (jp + jq).perm)
    np.testing.assert_array_equal(tp.inverse().perm, jp.inverse().perm)
    assert (tp + tp.inverse()).is_identity() and not tp.is_identity()
    assert T.Permutation.identity(T.Context(1247, 16)).is_identity()
    assert tp == T.Permutation(a) and tp != tq and hash(tp) == hash(T.Permutation(a))
    assert tp.perm.dtype == np.int32 and not tp.perm.flags.writeable
    assert (str(tp), repr(tp)) == (str(jp), repr(jp))
    assert tp.benes_plan() is tp.benes_plan()
    with pytest.raises(ValueError, match="length"):
        tp + T.Permutation.identity(20)
    r = T.Permutation.random(95, torch.Generator().manual_seed(0))
    assert sorted(r.perm.tolist()) == list(range(95))
    assert np.array_equal(r.perm, T.Permutation.random(95, torch.Generator().manual_seed(0)).perm)


@pytest.mark.parametrize("ctx_name", ["ctx", "small_ctx"])
def test_key_transform_and_permute_and_decrypt_match_jax(request, ctx_name):
    ctx = request.getfixturevalue(ctx_name)
    rng = np.random.default_rng(8)
    idx = rng.choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    perm = rng.permutation(ctx.n)
    jsk, tctx = J.SecretKey(ctx, idx), T.Context(ctx.n, ctx.d)
    tsk = convert.secret_key_from_numpy(tctx, idx, device="cpu")
    jp, tp = J.Permutation(perm), T.Permutation(perm)
    jpsk, tpsk = jsk.apply_permutation(jp), tsk.apply_permutation(tp)
    np.testing.assert_array_equal(tpsk.indices, jpsk.indices)
    np.testing.assert_array_equal(tpsk.mask, jpsk.mask)
    assert tpsk.device == tsk.device

    bits = np.array([1, 0, 1, 1, 0], np.uint8)  # xor 1
    jw = np.asarray(jsk.encrypt_batch(jnp.asarray(bits), 21, engine="counter"))
    jct, tct = J.Ciphertext(jnp.asarray(jw), ctx), convert.ciphertext_from_numpy(jw, tctx, "cpu")
    big = tct * tct + tct + tct   # 35 chunks, decrypt 1 ^ 1 ^ 1 = 1
    jpc = (jct * jct + jct + jct).apply_permutation(jp)
    tpc = big.apply_permutation(tp)
    np.testing.assert_array_equal(tpc.to_u64(), jpc.to_u64())
    assert int(tpsk.decrypt(tpc)) == int(jpsk.decrypt(jpc)) == 1
    _, jdec = jsk.permute_and_decrypt(jct, jp)
    for t, bit in [(tct, int(jdec)), (big, 1), (big + tct, 0)]:
        tout, tdec = tsk.permute_and_decrypt(t, tp)
        fout, fdec = benes_kernels.apply_benes_decrypt(t.wt, tp.benes_plan(), tpsk.mask_words)
        assert torch.equal(tout.wt, t.apply_permutation(tp).wt)
        assert torch.equal(fout, tout.wt)
        assert int(tdec) == int(fdec) == int(tpsk.decrypt(tout)) == int(tsk.decrypt(t)) == bit
        assert torch.equal(tout.apply_permutation(tp.inverse()).wt, t.wt)
    with pytest.raises(ValueError, match="length"):
        tct.apply_permutation(T.Permutation.identity(ctx.n + 1))
    with pytest.raises(ValueError, match="length"):
        tsk.apply_permutation(T.Permutation.identity(ctx.n + 1))


@pytest.fixture(params=range(len(SCENARIOS)), ids=[f"n{s['n']}" for s in SCENARIOS])
def sc(request):
    return SCENARIOS[request.param]


def _import_ct(sc, name, ctx):
    return T.Ciphertext.from_u64(np.array([int(x) for x in sc[name]], dtype=np.uint64), ctx, "cpu")


def _words64(strs):
    return np.array([int(x) for x in strs], dtype=np.uint64)


def test_golden_permutation_bit_exact(sc):
    """tests/test_golden.py:98-126 for the port, from the dumped arrays."""
    ctx = T.Context(sc["n"], sc["d"])
    p = T.Permutation(np.array(sc["perm"], dtype=np.int32))
    np.testing.assert_array_equal(p.inverse().perm, np.array(sc["inv_perm"], dtype=np.int32))
    assert (p + p.inverse()).is_identity()
    sk = T.SecretKey(ctx, np.array(sc["key"], dtype=np.int32), device="cpu")
    psk = sk.apply_permutation(p)
    np.testing.assert_array_equal(psk.indices, np.array(sc["permuted_key"], dtype=np.int32))
    pc1 = _import_ct(sc, "c1", ctx).apply_permutation(p)
    np.testing.assert_array_equal(pc1.to_u64(), _words64(sc["permuted_c1"]))
    assert int(psk.decrypt(pc1)) == sc["dec"]["permuted_c1"]


def test_golden_composed_permutation_bit_exact(sc):
    """tests/test_golden.py:129-150 for the port."""
    ctx = T.Context(sc["n"], sc["d"])
    p1 = T.Permutation(np.array(sc["perm"], dtype=np.int32))
    p2 = T.Permutation(np.array(sc["perm2"], dtype=np.int32))
    composed = p1 + p2
    np.testing.assert_array_equal(composed.perm, np.array(sc["composed_perm"], dtype=np.int32))
    sk = T.SecretKey(ctx, np.array(sc["key"], dtype=np.int32), device="cpu")
    csk = sk.apply_permutation(composed)
    np.testing.assert_array_equal(csk.indices, np.array(sc["composed_key"], dtype=np.int32))
    c1 = _import_ct(sc, "c1", ctx)
    cc1 = c1.apply_permutation(composed)
    np.testing.assert_array_equal(cc1.to_u64(), _words64(sc["composed_c1"]))
    assert int(csk.decrypt(cc1)) == sc["dec"]["composed_c1"]
    step = c1.apply_permutation(p1).apply_permutation(p2)
    np.testing.assert_array_equal(step.to_u64(), _words64(sc["composed_c1"]))
