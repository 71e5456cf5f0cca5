"""The port's multiplication chains against csgn_tpu.pipeline, bit-exactly:
`mul_chain` and `mul_chain_decrypt` words and parities (the ciphertexts
cross as numpy words, encrypted by the counter engine both packages share),
`chain_chunks`, and the budget refusals both packages raise at the same
inputs.  Tolerance: 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import pipeline as jpipe
from csgn_tpu_torch import convert, pipeline


def _chain(ctx, counts, seed, last_bit=1):
    """Ciphertexts of `counts` chunks, each an odd number of ones (decrypts
    to 1) except the last, which decrypts to `last_bit`, for both packages:
    (jax list, port list, jax key, port key).  One encrypt batch, sliced."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    jsk = J.SecretKey(ctx, idx)
    tctx = T.Context(ctx.n, ctx.d)
    tsk = convert.secret_key_from_numpy(tctx, idx, device="cpu")
    bits = rng.integers(0, 2, sum(counts)).astype(np.uint8)
    ends = np.cumsum(counts)
    for k, end in enumerate(ends):
        want = last_bit if k == len(counts) - 1 else 1
        bits[end - counts[k]] ^= int(bits[end - counts[k]:end].sum() % 2 != want)
    words = np.asarray(jsk.encrypt_batch(jnp.asarray(bits), seed, engine="counter"))
    jcts, tcts = [], []
    for t, end in zip(counts, ends):
        w = words[:, end - t:end]
        jcts.append(J.Ciphertext(jnp.asarray(w), ctx))
        tcts.append(convert.ciphertext_from_numpy(w, tctx, device="cpu"))
    return jcts, tcts, jsk, tsk


@pytest.mark.parametrize("counts,last_bit", [([3, 5, 2, 7], 1), ([2, 3, 4, 2], 0),
                                             ([1, 1, 1], 1), ([9], 1)])
def test_mul_chain_and_decrypt_match_jax(ctx, counts, last_bit):
    jcts, tcts, jsk, tsk = _chain(ctx, counts, sum(counts), last_bit)
    tprod = pipeline.mul_chain(tcts)
    np.testing.assert_array_equal(tprod.to_u64(), jpipe.mul_chain(jcts).to_u64())
    assert tprod.chunks == pipeline.chain_chunks(counts) == jpipe.chain_chunks(counts)
    twords, tbit = pipeline.mul_chain_decrypt(tcts, tsk)
    jwords, jbit = jpipe.mul_chain_decrypt(jcts, jsk)
    np.testing.assert_array_equal(twords.to_u64(), jwords.to_u64())
    np.testing.assert_array_equal(twords.to_u64(), tprod.to_u64())
    assert int(tbit) == int(jbit) == int(tsk.decrypt(tprod)) == last_bit


def test_chain_chunks():
    for counts in ([], [7], [2, 3, 5], [1 << 20, 1 << 20, 3]):
        assert pipeline.chain_chunks(counts) == jpipe.chain_chunks(counts)


def _refusal(fn):
    with pytest.raises(ValueError, match="chain intermediates peak") as err:
        fn()
    return str(err.value)


def test_budget_refusals_match_jax(small_ctx):
    """The same inputs are refused by both packages at the same budget, and
    at the default (the JAX package's constant, on the CPU)."""
    jcts, tcts, jsk, tsk = _chain(small_ctx, [4, 5, 6], 3)
    # Peak live chunks: max(4 * (1 + 5), 20 * (1 + 6)) = 140 chunks of 16 bytes.
    need = small_ctx.chunk_count_bytes(140)
    for budget in (need - 1, 100):
        for call in ("mul_chain", "mul_chain_decrypt"):
            jargs = (jcts,) if call == "mul_chain" else (jcts, jsk)
            targs = (tcts,) if call == "mul_chain" else (tcts, tsk)
            jmsg = _refusal(lambda: getattr(jpipe, call)(*jargs, budget_bytes=budget))
            tmsg = _refusal(lambda: getattr(pipeline, call)(*targs, budget_bytes=budget))
            assert "140 live chunks" in jmsg and "140 live chunks" in tmsg
    assert pipeline.mul_chain(tcts, budget_bytes=need).chunks == 120
    assert pipeline.mul_chain(tcts, budget_bytes=None).chunks == 120
    assert pipeline.HBM_BUDGET_BYTES == jpipe.HBM_BUDGET_BYTES
    assert pipeline.default_budget_bytes("cpu") == jpipe.HBM_BUDGET_BYTES

    # Two 2^16-chunk factors peak far past the default: refused before any
    # multiply allocates, by both.
    big_j, big_t, _, _ = _chain(small_ctx, [1 << 16, 1 << 16], 5)
    _refusal(lambda: jpipe.mul_chain(big_j))
    _refusal(lambda: pipeline.mul_chain(big_t))


def test_chain_argument_errors(small_ctx):
    jcts, tcts, jsk, tsk = _chain(small_ctx, [2, 3], 8)
    for mod in (jpipe, pipeline):
        with pytest.raises(ValueError, match="empty chain"):
            mod.mul_chain([])
        with pytest.raises(ValueError, match="empty chain"):
            mod.mul_chain_decrypt([], jsk if mod is jpipe else tsk)
    other_j, other_t, osk_j, osk_t = _chain(J.Context(100, 4), [2], 9)
    with pytest.raises(ValueError, match="context mismatch in chain"):
        jpipe.mul_chain(jcts + other_j)
    with pytest.raises(ValueError, match="context mismatch in chain"):
        pipeline.mul_chain(tcts + other_t)
    with pytest.raises(ValueError, match="secret key context mismatch"):
        jpipe.mul_chain_decrypt(jcts, osk_j)
    with pytest.raises(ValueError, match="secret key context mismatch"):
        pipeline.mul_chain_decrypt(tcts, osk_t)
