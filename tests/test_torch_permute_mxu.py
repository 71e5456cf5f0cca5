"""The one-hot permutation (`csgn_tpu_torch.ops.permute_mxu`) on the CPU
against csgn_tpu's (`csgn_tpu.ops.permute_mxu`), the port's Beneš plain
version and the gather oracle `core.permute_chunks`, bit-exactly, at
n in {32, 95, 1247}.  Words, bits past n included, and permutations are
made by numpy from fixed seeds.  Tolerance: 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgn_tpu.ops import permute_mxu as jmxu
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.layout import words32_for, words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import benes_kernels, core
from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.ops import permute_mxu as tmxu


@pytest.mark.parametrize("n", [32, 95, 1247])
def test_permute_chunks_mxu_matches_jax_and_benes(n):
    rng = np.random.default_rng(n)
    w = words32_for(n)
    perm = rng.permutation(n).astype(np.int32)
    words = rng.integers(0, 2**32, (w, 37), dtype=np.uint32)
    tw = words_from_numpy(words, "cpu")
    got = tmxu.permute_chunks_mxu(tw, tmxu.onehot_matrix(perm, n, "cpu"), n)
    want = jmxu.permute_chunks_mxu(jnp.asarray(words), jmxu.onehot_matrix(perm, n), n)
    # Bits past n (set here) are dropped by both, as by JAX's unpack to n rows.
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    canon = words_from_numpy(words & Context(n, 4).valid_mask[:, None], "cpu")
    got_c = tmxu.permute_chunks_mxu(canon, tmxu.onehot_matrix(perm, n, "cpu"), n)
    assert torch.equal(got_c, benes_kernels.apply_benes(canon, pb.build_plan(perm, n)))
    assert torch.equal(got_c, core.permute_chunks(canon, torch.from_numpy(perm), n))


def test_onehot_matrix_matches_jax():
    rng = np.random.default_rng(7)
    for n in (32, 95, 130):
        perm = rng.permutation(n)
        got = tmxu.onehot_matrix(perm, n, "cpu")
        want = np.asarray(jmxu.onehot_matrix(perm, n)).astype(np.float32)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape == (-(-n // 128) * 128,) * 2
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_permute_chunks_mxu_batched():
    """[B, W, C] words: one permutation over every element, each element
    equal to JAX's 2-D result.  (JAX's own batched call contracts its bit
    rows past the batch axis and returns [n_pad, ...]-shaped words, not the
    documented ``[..., W, C]``; the port keeps the documented shape.)"""
    rng = np.random.default_rng(11)
    n = 95
    perm = rng.permutation(n).astype(np.int32)
    words = rng.integers(0, 2**32, (3, words32_for(n), 9), dtype=np.uint32)
    got = tmxu.permute_chunks_mxu(words_from_numpy(words, "cpu"),
                                  tmxu.onehot_matrix(perm, n, "cpu"), n)
    assert got.shape == (3, words32_for(n), 9)
    for e in range(3):
        want = jmxu.permute_chunks_mxu(jnp.asarray(words[e]), jmxu.onehot_matrix(perm, n), n)
        np.testing.assert_array_equal(words_to_numpy(got[e]), np.asarray(want))
