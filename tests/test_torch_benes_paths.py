"""What the Beneš kernel's two paths assume of a plan, on the CPU.

csrc/benes.cu's register path unrolls one block per cross-word delta of the
fixed stage sequence 1, 2, ..., n_pad/2, ..., 2, 1, and `benes_path` routes
a network to it up to 64 words (n <= 2048), to the shared path up to 512
words (n <= 16384) and to the wide path above.  The
operation count `network_ops` is what bounds both on the card
(chip_smoke.py's bound column).  Tolerance: exact.
"""

import numpy as np
import pytest

from csgn_tpu.ops import permute_benes as jpb
from csgn_tpu_torch.ops import benes_kernels
from csgn_tpu_torch.ops import permute_benes as pb

NS = [2, 20, 33, 100, 257, 600, 1247, 2048, 2049, 4095]


@pytest.mark.parametrize("n", NS)
def test_plan_deltas_are_the_register_path_sequence(n):
    rng = np.random.default_rng(n)
    for perm in (rng.permutation(n), np.arange(n)):
        plan = pb.build_plan(perm, n)
        assert plan.deltas == benes_kernels.network_deltas(plan.n_pad)
        assert plan.deltas == jpb.build_plan(perm, n).deltas
    m = plan.n_pad.bit_length() - 1          # n_pad = 2^m: 2m - 1 stages
    assert len(plan.deltas) == 2 * m - 1 and max(plan.deltas) == plan.n_pad // 2


@pytest.mark.parametrize("n", NS)
def test_path_choice(n):
    """Register path for WP = n_pad / 32 <= 64, shared path above (PERF.md)."""
    plan = pb.build_plan(np.arange(n), n)
    want = "register" if plan.words_pad <= 64 else "shared"
    assert benes_kernels.benes_path(plan.words_pad) == want
    assert (want == "register") == (n <= 2048)
    # Every cross-word delta of a register-path network has its unrolled
    # block in csrc/benes.cu: R = delta / 32 in 1, 2, ..., 32.
    if want == "register":
        assert {d // 32 for d in plan.deltas if d >= 32} <= {1, 2, 4, 8, 16, 32}


def test_path_limits():
    """Register path to 64 words, shared path to 512, the wide path above at
    any width: no network is refused for its size."""
    assert benes_kernels.REGISTER_WORDS_PAD == 64
    assert benes_kernels.SHARED_WORDS_PAD == 512
    assert benes_kernels.benes_path(1) == "register"
    assert benes_kernels.benes_path(128) == "shared"
    assert benes_kernels.benes_path(benes_kernels.SHARED_WORDS_PAD) == "shared"
    tile = benes_kernels.WIDE_TILE_WORDS_PAD
    assert tile * 4 <= 227 * 1024 < 2 * tile * 4   # one column's tile fits, two do not
    for wp in (2 * benes_kernels.SHARED_WORDS_PAD, 4096, tile, 2 * tile, 1 << 20):
        assert benes_kernels.benes_path(wp) == "wide"


def _hand_plan():
    """A 512-bit network (WP = 16, 17 stages) with a few masks set by hand."""
    n_pad = 512
    deltas = benes_kernels.network_deltas(n_pad)
    masks = np.zeros((len(deltas), 16), dtype=np.uint32)
    rows = [8] * len(deltas)
    masks[0, [0, 3]] = [0x1, 0x80000000]     # delta 1: two in-word words
    masks[0, 12] = 0xFFFF                    # beyond the 8 live rows: not counted
    masks[5, [0, 2]] = [0xF0, 0x3]           # delta 32 (R = 1): two pairs
    masks[8, 7] = 0x1                        # delta 256 (R = 8): one pair
    rows[8] = 16
    masks[16, 7] = 0x4                       # delta 1: one in-word word
    return pb.BenesPlan(n=500, n_pad=n_pad, deltas=deltas, masks=masks, rows=tuple(rows))


def test_network_ops_hand_count():
    plan = _hand_plan()
    assert plan.deltas[5] == 32 and plan.deltas[8] == 256 and plan.deltas[16] == 1
    # 3 in-word words x 4 + 3 cross-word pairs x 2.
    assert benes_kernels.network_ops(plan) == 3 * 4 + 3 * 2
    other = pb.BenesPlan(n=500, n_pad=512, deltas=plan.deltas, masks=np.zeros_like(plan.masks),
                         rows=plan.rows)
    assert benes_kernels.network_ops(pb.stack_plans([plan, other, plan])) == [18, 0, 18]


def test_network_ops_at_the_timed_size():
    """Random plans at n = 1247 (the timed rows' size): 2,022 operations a
    chunk on these seeds (389 in-word words, 233 pairs), 0.127 ms over 2^20
    chunks at 16.73 T op/s."""
    plans = [pb.build_plan(np.random.default_rng(s).permutation(1247), 1247) for s in range(3)]
    assert [benes_kernels.network_ops(p) for p in plans] == [2022, 2022, 2018]
    assert benes_kernels.network_ops(pb.stack_plans(plans)) == [2022, 2022, 2018]
    assert benes_kernels.network_ops(pb.build_plan(np.arange(1247), 1247)) == 0


def test_plain_network_past_16384_bits_equals_the_jax_package():
    """n = 20000 (WP = 1024, the wide path's width on the card): the plain K8
    and K12 the kernels are held to on the card equal the JAX package's
    plain Beneš network and the gather oracle."""
    import jax.numpy as jnp
    import torch

    from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
    from csgn_tpu_torch.ops import core

    n, chunks = 20000, 33
    rng = np.random.default_rng(20000)
    perm = rng.permutation(n)
    plan = pb.build_plan(perm, n)
    assert plan.words_pad == 1024 and benes_kernels.benes_path(plan.words_pad) == "wide"
    w = 2 * -(-n // 64)
    x = rng.integers(0, 2**32, (w, chunks), dtype=np.uint32)
    x[-1] &= np.uint32(0xFFFFFFFF << (32 - n % 32) & 0xFFFFFFFF)   # canonical: bits < n
    got = benes_kernels.apply_benes_plain(words_from_numpy(x, "cpu"), plan)
    want = jpb.apply_benes(jnp.asarray(x), jpb.build_plan(perm, n))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    assert torch.equal(got, core.permute_chunks(words_from_numpy(x, "cpu"),
                                                torch.from_numpy(perm), n))
