"""What the Beneš kernel's paths assume of a plan, on the CPU.

csrc/benes.cu's register path unrolls one block per cross-word delta of the
fixed stage sequence 1, 2, ..., n_pad/2, ..., 2, 1, and `benes_path` routes
a network to it up to 64 words (n <= 2048), to the lane-group path
(csrc/benes_lanes.cu) up to 2048 words (n <= 65536) and to the wide path
above.  The lane-group path's arithmetic is emulated here in numpy, lane by
lane, on the masks `lane_masks` lays out, and held to the plain network of
both packages; its tile swizzle is checked for distinct banks.  The
operation count `network_ops` is what bounds the paths on the card
(`tools/ab_times.py benes-lanes`' bound).  Tolerance: exact.
"""

import functools

import numpy as np
import pytest
import torch

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
    """Register path for WP = n_pad / 32 <= 64, the lane-group path above
    (PERF.md)."""
    plan = pb.build_plan(np.arange(n), n)
    want = "register" if plan.words_pad <= 64 else "lanes"
    assert benes_kernels.benes_path(plan.words_pad) == want
    assert (want == "register") == (n <= 2048)
    # Every cross-word delta of a register-path network has its unrolled
    # block in csrc/benes.cu: R = delta / 32 in 1, 2, ..., 32.
    if want == "register":
        assert {d // 32 for d in plan.deltas if d >= 32} <= {1, 2, 4, 8, 16, 32}


def test_path_limits():
    """Register path to 64 words, the lane-group path to 2048 (groups of 2
    to 32 lanes of 64 words), the wide path above at any width: no network
    is refused for its size."""
    assert benes_kernels.REGISTER_WORDS_PAD == 64
    assert benes_kernels.LANES_WORDS_PAD == 2048
    lanes = benes_kernels.LANES_WORDS_PAD // benes_kernels.LANE_WORDS
    assert benes_kernels.LANE_WORDS == 64 and lanes == 32
    assert benes_kernels.benes_path(1) == "register"
    for wp in (128, 256, 512, 1024, benes_kernels.LANES_WORDS_PAD):
        assert benes_kernels.benes_path(wp) == "lanes"
    tile = benes_kernels.WIDE_TILE_WORDS_PAD
    assert tile * 4 <= 227 * 1024 < 2 * tile * 4   # one column's tile fits, two do not
    for wp in (2 * benes_kernels.LANES_WORDS_PAD, 4096, tile, 2 * tile, 1 << 20):
        assert benes_kernels.benes_path(wp) == "wide"


@pytest.mark.parametrize("wp", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("chunks", [1, 4, 37, 1028, 1 << 24, (1 << 24) + 37])
def test_lanes_form_by_shape(wp, chunks):
    """The lane-group path's ring form takes WP = 128 over rows of whole
    16-byte quads (chunks % 4 == 0) at aligned addresses; every other
    width, a ragged chunk count or an unaligned base keeps the tile form."""
    want = "ring" if wp == 128 and chunks % 4 == 0 else "tile"
    assert benes_kernels.lanes_form(wp, chunks) == want
    assert benes_kernels.lanes_form(wp, chunks, aligned=False) == "tile"


REGISTER_NS = [20, 33, 100, 257, 600, 1247, 2048]


@pytest.mark.parametrize("n", REGISTER_NS + [4095])
def test_in_word_masks_mark_only_upper_bits(n):
    """Every in-word mask word of a plan marks only bits b with b & d != 0
    (the upper bit of each pair, MSB-first positions i with i & d == 0),
    which the register path's in-word stage assumes (csrc/benes.cu
    `in_word_fma`): random plans, the identity and a stack of both."""
    rng = np.random.default_rng(n)
    plans = [pb.build_plan(rng.permutation(n), n) for _ in range(3)]
    plans.append(pb.build_plan(np.arange(n), n))
    for plan in plans + [pb.stack_plans(plans)]:
        masks = plan.masks if plan.masks.ndim == 3 else plan.masks[None]
        for s, d in enumerate(plan.deltas):
            if d < 32:
                lower = np.uint32(sum(1 << b for b in range(32) if not b & d))
                assert not np.any(masks[:, s] & lower), (n, s, d)


def _register_network(words: np.ndarray, plan) -> np.ndarray:
    """The register path's network in numpy uint32, stage by stage as
    csrc/benes.cu computes it: an in-word stage on the pre-shifted mask with
    the multiply forms (`in_word_fma`), a cross-word stage as the bit select
    of each pair of rows, over each stage's live rows."""
    w, c = words.shape
    col = np.zeros((plan.words_pad, c), dtype=np.uint64)
    col[:min(w, plan.words_pad)] = words[:plan.words_pad]
    m32 = 0xFFFFFFFF
    for mask, d, rows in zip(plan.masks.astype(np.uint64), plan.deltas, plan.rows):
        if d < 32:
            m = (mask[:rows] >> np.uint64(d))[:, None]
            v = col[:rows]
            hi = (v * np.uint64(1 << (32 - d))) >> np.uint64(32)   # umulhi(v, 2^(32 - d))
            t = (v ^ hi) & m
            col[:rows] = v ^ ((t * np.uint64(1 + (1 << d))) & np.uint64(m32))
        else:
            r = d // 32
            lo = np.array([i for i in range(rows) if not i & r], dtype=np.int64)
            sel = mask[lo][:, None]
            a, b = col[lo], col[lo + r]
            col[lo] = (a & ~sel & np.uint64(m32)) | (b & sel)
            col[lo + r] = (b & ~sel & np.uint64(m32)) | (a & sel)
    out = np.zeros_like(words)
    out[:min(w, plan.words_pad)] = col[:min(w, plan.words_pad)].astype(np.uint32)
    return out


@pytest.mark.parametrize("n", REGISTER_NS)
def test_register_network_emulation_equals_both_plain_networks(n):
    """The register path's arithmetic, multiply forms and all, emulated in
    numpy, is bit-equal to the port's plain K8 and to the JAX package's
    plain network, for random plans and the identity."""
    import jax.numpy as jnp

    from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy

    rng = np.random.default_rng(n + 1)
    w = 2 * -(-n // 64)
    valid = np.zeros(w, np.uint32)
    np.bitwise_or.at(valid, np.arange(n) // 32, np.uint32(1) << (31 - np.arange(n) % 32)
                     .astype(np.uint32))
    x = rng.integers(0, 2**32, (w, 257), dtype=np.uint32) & valid[:, None]
    for perm in (rng.permutation(n), rng.permutation(n), np.arange(n)):
        plan = pb.build_plan(perm, n)
        got = _register_network(x, plan)
        want = words_to_numpy(benes_kernels.apply_benes_plain(words_from_numpy(x, "cpu"), plan))
        np.testing.assert_array_equal(got, want)
        jplan = jpb.BenesPlan(n=plan.n, n_pad=plan.n_pad, deltas=plan.deltas, masks=plan.masks,
                              rows=plan.rows)
        np.testing.assert_array_equal(got, np.asarray(jpb.apply_benes(jnp.asarray(x), jplan)))


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
    """n = 20000 (WP = 1024, the lane-group path's width on the card): the plain K8
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
    assert plan.words_pad == 1024 and benes_kernels.benes_path(plan.words_pad) == "lanes"
    w = 2 * -(-n // 64)
    x = rng.integers(0, 2**32, (w, chunks), dtype=np.uint32)
    x[-1] &= np.uint32(0xFFFFFFFF << (32 - n % 32) & 0xFFFFFFFF)   # canonical: bits < n
    got = benes_kernels.apply_benes_plain(words_from_numpy(x, "cpu"), plan)
    want = jpb.apply_benes(jnp.asarray(x), jpb.build_plan(perm, n))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    assert torch.equal(got, core.permute_chunks(words_from_numpy(x, "cpu"),
                                                torch.from_numpy(perm), n))


# ---------------------------------------------------------------------------
# The lane-group path (csrc/benes_lanes.cu), emulated lane by lane
# ---------------------------------------------------------------------------

LANE_NS = [2049, 4095, 8191, 16383, 16385, 20000]     # WP = 128, 128, 256, 512, 1024, 1024


@functools.cache
def _lane_plans(n):
    """A random plan and the identity's at n (cached: routing takes about a
    second on the host at n = 20000)."""
    rng = np.random.default_rng(n + 7)
    return pb.build_plan(rng.permutation(n), n), pb.build_plan(np.arange(n), n)


def _per_lane(words, k, lanes):
    """[..., WP] in the lane layout [K/4, L, 4] -> [..., L, K]: lane q's
    local rows."""
    *lead, _ = words.shape
    return words.reshape(*lead, k // 4, lanes, 4).swapaxes(-3, -2).reshape(*lead, lanes, k)


def _lane_key(key, w, wp, lanes):
    """The key staged as csrc/benes_lanes.cu stages it: word e of the lane
    layout is network row ((e // 4L) * 4 + e % 4) * L + (e // 4) % L."""
    e = np.arange(wp)
    r = ((e // (4 * lanes)) * 4 + (e & 3)) * lanes + ((e >> 2) & (lanes - 1))
    padded = np.zeros(wp, np.uint32)                                   # rows [w, WP): zero
    padded[:w] = key
    return padded[r]


def _emulate_lanes(x, plan, masks, k, key=None):
    """The lane-group kernel on x uint32 [W, C] (W <= WP) with the plan's
    lane-layout masks [S, WP]: lane q of a chunk's group holds rows i * L +
    q; in-word and R >= L stages run on a lane's own rows (local R / L),
    R < L stages exchange with lane q ^ R under the lower lane's mask; each
    stage runs the local groups of 8 rows g with g * L < its live rows.
    Returns the output words and, with `key`, the count of chunks whose
    output misses no key bit."""
    wp, (w, c) = plan.words_pad, x.shape
    lanes = wp // k
    pad = np.zeros((wp, c), np.uint32)
    pad[:w] = x
    col = pad.reshape(k, lanes, c).transpose(2, 1, 0).copy()           # [C, L, K]
    per_lane = _per_lane(masks, k, lanes)                              # [S, L, K]
    _, sched = pb.device_operands(plan, "cpu")
    q = np.arange(lanes)
    local = np.arange(k)
    for s, (delta, rows) in enumerate(sched.numpy().tolist()):
        live = local // 8 * 8 * lanes < rows                           # per local row
        m = per_lane[s]
        if delta < 32:
            t = (col ^ (col << np.uint32(delta))) & m
            new = col ^ t ^ (t >> np.uint32(delta))
        elif delta // 32 < lanes:
            rr = delta // 32
            mm = m[q & ~rr]
            new = (col & ~mm) | (col[:, q ^ rr] & mm)
        else:
            rl = delta // 32 // lanes
            lo = local[(local & rl) == 0]
            a, b, sel = col[:, :, lo], col[:, :, lo + rl], m[:, lo]
            new = col.copy()
            new[:, :, lo] = (a & ~sel) | (b & sel)
            new[:, :, lo + rl] = (b & ~sel) | (a & sel)
            live[lo + rl] = live[lo]                                    # a pair goes by its lower row
        col = np.where(live, new, col)
    out = col.transpose(2, 1, 0).reshape(wp, c)[:w]
    if key is None:
        return out, None
    keys = _per_lane(_lane_key(key, w, wp, lanes), k, lanes)           # [L, K]
    miss = np.bitwise_or.reduce(np.bitwise_or.reduce(keys & ~col, axis=2), axis=1)
    return out, int(np.count_nonzero(miss == 0))


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("n", LANE_NS)
def test_lane_emulation_equals_both_plain_networks(n, k, monkeypatch):
    """The emulated lane-group network, on `lane_masks`' layout, is
    bit-equal to the port's plain K8 and K12 and to the JAX package's plain
    network, for a random plan and the identity (every stage off); every
    fourth chunk holds the key's bits, so its output matches the output
    key."""
    import jax.numpy as jnp

    from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy

    monkeypatch.setattr(benes_kernels, "LANE_WORDS", k)
    rng = np.random.default_rng(n * 3 + k)
    w, chunks = 2 * -(-n // 64), 37
    valid = np.zeros(w, np.uint32)
    np.bitwise_or.at(valid, np.arange(n) // 32, np.uint32(1) << (31 - np.arange(n) % 32)
                     .astype(np.uint32))
    for plan in _lane_plans(n):
        assert plan.deltas == benes_kernels.network_deltas(plan.n_pad)
        x = rng.integers(0, 2**32, (w, chunks), dtype=np.uint32) & valid[:, None]
        bits = rng.choice(n, 16, replace=False)
        key = np.zeros(w, np.uint32)
        np.bitwise_or.at(key, bits // 32, np.uint32(1) << (31 - bits % 32).astype(np.uint32))
        x[:, ::4] |= key[:, None]
        xt = words_from_numpy(x, "cpu")
        out_key = benes_kernels.apply_benes_plain(words_from_numpy(key[:, None], "cpu"), plan)
        plan._device.pop("cpu/lanes", None)       # laid out for this K
        masks = words_to_numpy(benes_kernels.lane_masks(plan, "cpu"))
        plan._device.pop("cpu/lanes", None)
        got, count = _emulate_lanes(x, plan, masks, k, words_to_numpy(out_key)[:, 0])
        np.testing.assert_array_equal(got, words_to_numpy(benes_kernels.apply_benes_plain(xt, plan)))
        jplan = jpb.BenesPlan(n=plan.n, n_pad=plan.n_pad, deltas=plan.deltas, masks=plan.masks,
                              rows=plan.rows)
        np.testing.assert_array_equal(got, np.asarray(jpb.apply_benes(jnp.asarray(x), jplan)))
        _, want_count = benes_kernels.apply_benes_decrypt_plain(xt, plan, out_key[:, 0],
                                                                return_count=True)
        assert count == int(want_count) >= len(range(0, chunks, 4))


def _tile_at(r, k, lanes, cb, g, shift):
    """csrc/benes_lanes.cu `tile_at`: word (r, k) of the tile [WP][CB]."""
    return r * cb + (k ^ (((r & (lanes - 1)) >> shift) * g))


@pytest.mark.parametrize("k,wp,threads", [(64, 128, 128), (64, 256, 128), (64, 512, 128),
                                          (64, 1024, 512), (64, 1024, 128), (64, 2048, 128),
                                          (32, 128, 128), (32, 1024, 128), (32, 1024, 512)])
def test_lane_tile_swizzle_is_conflict_free(k, wp, threads):
    """The tile's swizzle is a bijection of [WP] x [CB]; a warp's column
    reads (lane (g, q) at rows i L + q, column w G + g) and its coalesced
    writes (32 consecutive words of the row-major walk) each hit 32
    distinct banks."""
    lanes = wp // k
    g, warps = 32 // lanes, threads // 32
    cb = warps * g
    shift = max(0, int(np.log2(lanes)) - int(np.log2(warps)))
    r, c = np.meshgrid(np.arange(wp), np.arange(cb), indexing="ij")
    at = _tile_at(r, c, lanes, cb, g, shift)
    assert sorted(at.ravel().tolist()) == list(range(wp * cb))
    lane = np.arange(32)
    q, grp = lane % lanes, lane // lanes
    for warp in range(warps):
        for i in (0, 1, k - 1):
            banks = _tile_at(i * lanes + q, warp * g + grp, lanes, cb, g, shift) % 32
            assert len(set(banks.tolist())) == 32
    for e0 in range(0, wp * cb, 32 * 7):
        e = e0 + lane
        assert len(set((_tile_at(e // cb, e % cb, lanes, cb, g, shift) % 32).tolist())) == 32

