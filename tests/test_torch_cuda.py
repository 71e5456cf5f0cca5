"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor csgn_tpu, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)  Equality is
exact: the kernels are integer code.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from csgn_tpu_torch import Ciphertext, CiphertextBatch, Context, Permutation, SecretKey, rng
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import benes_kernels, encrypt_kernels, kernels
from csgn_tpu_torch.ops import core
from csgn_tpu_torch.ops import permute_benes as pb
from portbench.reference import rekey

pytestmark = pytest.mark.cuda

SKIP_REASON = "needs an NVIDIA GPU"
CTX = Context(1247, 16)
SMALL = Context(95, 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip(SKIP_REASON)
    return torch.device("cuda")


def _key(ctx, seed, dev):
    rng = np.random.default_rng(seed)
    return SecretKey(ctx, rng.choice(ctx.n, ctx.d, replace=False), dev)


def _words(ctx, chunks, seed, dev, mask=None, forced=()):
    """Random canonical words [W, chunks] on `dev`, with the key mask ORed
    into the `forced` columns so matches exist."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(ctx.words32, chunks), dtype=np.uint32)
    w &= ctx.valid_mask[:, None]
    if len(forced):
        w[:, list(forced)] |= mask[:, None]
    return words_from_numpy(w, dev)


@pytest.mark.parametrize("ctx", [CTX, SMALL], ids=["1247x16", "95x4"])
@pytest.mark.parametrize("t1,t2", [(1, 1), (3, 5), (13, 7), (9, 33), (4, 128), (128, 130)])
def test_mul_and_mul_decrypt_match_plain(dev, ctx, t1, t2):
    sk = _key(ctx, t1 * 1000 + t2, dev)
    a = _words(ctx, t1, t1, dev, sk.mask, forced=range(0, t1, 2))
    b = _words(ctx, t2, t2 + 7, dev, sk.mask, forced=range(0, t2, 3))
    want = kernels.mul_chunks_plain(a, b)
    assert torch.equal(kernels.mul_chunks(a, b), want)
    prod, count = kernels.mul_decrypt(a, b, sk.mask_words, return_count=True)
    _, want_count = kernels.mul_decrypt_plain(a, b, sk.mask_words, return_count=True)
    assert torch.equal(prod, want)
    assert int(count) == int(want_count) >= len(range(0, t1, 2)) * len(range(0, t2, 3))
    _, parity = kernels.mul_decrypt(a, b, sk.mask_words)
    assert int(parity) == int(want_count) & 1


@pytest.mark.parametrize("chunks", [1, 19, 1025, 4096])
def test_decrypt_matches_plain(dev, chunks):
    sk = _key(CTX, chunks, dev)
    words = _words(CTX, chunks, chunks, dev, sk.mask, forced=range(0, chunks, 5))
    m = sk.mask_words
    assert int(kernels.decrypt_parity(words, m)) == int(kernels.decrypt_parity_plain(words, m))
    assert torch.equal(kernels.chunk_matches(words, m), kernels.chunk_matches_plain(words, m))


def test_decrypt_unaligned_words_take_scalar_loads(dev):
    """A contiguous view 4 bytes off a 16-byte boundary must not take the
    vectorized loads."""
    sk = _key(CTX, 3, dev)
    src = _words(CTX, 64, 3, dev, sk.mask, forced=(1, 2, 9))
    flat = torch.empty(src.numel() + 1, dtype=torch.int32, device=dev)
    view = flat[1:].view(src.shape)
    view.copy_(src)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(kernels.chunk_matches(view, sk.mask_words),
                       kernels.chunk_matches_plain(src, sk.mask_words))
    assert int(kernels.decrypt_parity(view, sk.mask_words)) == 1


@pytest.mark.parametrize("ctx", [CTX, SMALL], ids=["1247x16", "95x4"])
@pytest.mark.parametrize("batch", [1, 129, 300, 4097])
def test_encrypt_matches_plain_and_invariants(dev, ctx, batch):
    sk = _key(ctx, batch, dev)
    bits = torch.from_numpy(np.random.default_rng(batch).integers(0, 2, batch)).to(dev)
    args = (bits, *sk.encrypt_operands)
    got = encrypt_kernels.encrypt_bits_counter(123456789012, *args)
    assert torch.equal(got, encrypt_kernels.encrypt_bits_counter_plain(123456789012, *args))
    assert torch.equal(kernels.chunk_matches(got, sk.mask_words), bits.to(torch.int32))
    assert not (got & ~sk.encrypt_operands[2][:, None]).any()


def test_main_path_on_card_equals_cpu(dev):
    """The public API on the card gives the CPU path's words and bits."""
    idx = np.random.default_rng(0).choice(CTX.n, CTX.d, replace=False)
    out = {}
    for device in ("cpu", dev):
        sk = SecretKey(CTX, idx, device)
        c1 = Ciphertext(sk.encrypt_batch([1, 0, 1, 1, 0], 11), CTX)
        c2 = Ciphertext(sk.encrypt_batch([1, 1, 1], 12), CTX)
        prod, p = sk.mul_and_decrypt(c1, c2)
        out[str(device)] = ((c1 + c2).to_u64(), prod.to_u64(), (c1 * c2).to_u64(),
                            int(p), int(sk.decrypt(prod)))
    cpu, gpu = out["cpu"], out[str(dev)]
    for x, y in zip(cpu[:3], gpu[:3]):
        np.testing.assert_array_equal(x, y)
    assert cpu[3:] == gpu[3:] == (1, 1)


def test_launch_counters_count_kernel_launches(dev):
    before = dict(kernels.LAUNCHES)
    sk = _key(CTX, 1, dev)
    c = Ciphertext(sk.encrypt_batch([1, 1], 5), CTX)
    sk.decrypt_batch(c.wt)
    sk.decrypt(c)
    sk.mul_and_decrypt(c, c)
    c * c
    p = Permutation.random(CTX, rng.key(1))
    cc = c.apply_permutation(p)
    b = CiphertextBatch.stack([c, cc])
    sk.decrypt_batch(b * b)
    sk.mul_and_decrypt_batch(b, b)
    b.apply_permutations([p, p.inverse()])
    benes_kernels.apply_benes_decrypt(c.wt, p.benes_plan(), sk.apply_permutation(p).mask_words)
    kernels.chunk_matches(b.wt, sk.mask_words)
    # Every product above has t1*t2 % 4 == 0, so the multiply's aligned mode
    # serves it; the unaligned and tiled modes count under their own keys.
    # The Philox engine, its stream dump, the default engine (K14; the
    # encrypt above takes an integer seed), the write anchor and the Beneš
    # kernel's lane-group and wide paths (n > 2048) are not called.
    unused = ("encrypt_bits_philox", "philox_tile", "philox_tile_4byte", "philox_column",
              "philox_streams", "encrypt_bits_threefry", "fill_anchor", "benes_lanes",
              "benes_wide")
    for name in before:
        want = before[name] + (0 if name in unused or name.endswith((
            "_unaligned", "_tiled", "_unaligned_batched", "_tiled_batched")) else 1)
        assert kernels.LAUNCHES[name] == want, name


def _perm_words(n, lead, chunks, seed, dev):
    ctx = Context(n, min(16, n // 2))
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(*lead, ctx.words32, chunks), dtype=np.uint32)
    return ctx, rng, words_from_numpy(w & ctx.valid_mask[:, None], dev)


# Every network width of the register path (WP = n_pad / 32 = 1, 2, 4, ...,
# 64) and WP = 128 of the lane-group path.
BENES_WP_NS = [17, 20, 31, 33, 50, 100, 200, 400, 700, 1247, 2048, 2049, 4095]


@pytest.mark.parametrize("n", BENES_WP_NS)
@pytest.mark.parametrize("chunks", [1, 127, 129, 255, 256, 257, 3 * 256 + 37, 1025])
def test_benes_k8_k12_match_plain(dev, n, chunks):
    """Ragged chunk counts and those around the register path's 256-column
    block, and n < 32 (W = 2 rows against a 1-row network), at every
    network width."""
    ctx, rng, x = _perm_words(n, (), chunks, n * 10 + chunks, dev)
    p = Permutation(rng.permutation(n))
    plan = p.benes_plan()
    want = benes_kernels.apply_benes_plain(x, plan)
    got = benes_kernels.apply_benes(x, plan)
    assert torch.equal(got, want)
    assert torch.equal(got, core.permute_chunks(x, torch.tensor(p.perm), n))
    sk = _key(ctx, n, "cpu").apply_permutation(p)
    key = sk.mask_words.to(dev)
    # Force matches with the output key into chosen columns: permute the
    # key's mask back through p^-1 and OR it into the input.
    pre = core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
    x[:, 0:chunks:3] |= pre
    out, count = benes_kernels.apply_benes_decrypt(x, plan, key, return_count=True)
    want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key,
                                                                   return_count=True)
    assert torch.equal(out, want_out)
    assert int(count) == int(want_count) >= len(range(0, chunks, 3))
    assert int(benes_kernels.apply_benes_decrypt(x, plan, key)[1]) == int(want_count) & 1


@pytest.mark.parametrize("n", [20, 1247])
@pytest.mark.parametrize("k,chunks", [(1, 129), (3, 1), (3, 1025), (64, 33)])
def test_benes_k9_and_shared_plan_match_plain(dev, n, k, chunks):
    _, rng, x = _perm_words(n, (k,), chunks, k * 100 + chunks, dev)
    perms = [Permutation(rng.permutation(n)) for _ in range(k)]
    stacked = pb.stack_plans([q.benes_plan() for q in perms])
    got = benes_kernels.apply_benes_batch(x, stacked)
    assert torch.equal(got, benes_kernels.apply_benes_batch_plain(x, stacked))
    for i in (0, k - 1):
        assert torch.equal(got[i], benes_kernels.apply_benes(x[i].contiguous(),
                                                             perms[i].benes_plan()))
    shared = benes_kernels.apply_benes(x, perms[0].benes_plan())
    assert torch.equal(shared, benes_kernels.apply_benes_plain(x, perms[0].benes_plan()))


def _benes_on(path, name, x, plan, key=None):
    stride = len(plan.deltas) * plan.words_pad if name == "apply_benes_batch" else 0
    return benes_kernels._benes_cuda(name, x, plan, stride, key, path=path)


@pytest.mark.parametrize("path", ["register", "wide"])
@pytest.mark.parametrize("n", [20, 1247])
def test_benes_zero_stage_plans(dev, n, path):
    """The identity (every stage off) and a transposition (most stages off)
    on both paths, at n < 32 too."""
    _, _, x = _perm_words(n, (), 300, 5, dev)
    swap = np.arange(n)
    swap[3], swap[n - 7] = swap[n - 7], swap[3]
    for p in (Permutation.identity(n), Permutation(swap)):
        assert torch.equal(_benes_on(path, "apply_benes", x, p.benes_plan())[0],
                           benes_kernels.apply_benes_plain(x, p.benes_plan()))
    assert torch.equal(_benes_on(path, "apply_benes", x, Permutation.identity(n).benes_plan())[0],
                       x)


@pytest.mark.parametrize("path", ["register", "wide"])
@pytest.mark.parametrize("n", [20, 50, 100, 200, 400, 700, 1247, 2048])
def test_benes_both_paths_match_plain(dev, n, path):
    """K8, K12 (count and parity) and K9 forced onto each path at every
    register-path width, over a ragged 129-column grid."""
    ctx, rng, x = _perm_words(n, (), 129, n + 1, dev)
    p = Permutation(rng.permutation(n))
    plan = p.benes_plan()
    assert benes_kernels.benes_path(plan.words_pad) == "register"
    before = dict(kernels.LAUNCHES)
    assert torch.equal(_benes_on(path, "apply_benes", x, plan)[0],
                       benes_kernels.apply_benes_plain(x, plan))
    key = _key(ctx, n, "cpu").apply_permutation(p).mask_words.to(dev)
    x[:, 0:129:4] |= core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
    out, count = _benes_on(path, "apply_benes_decrypt", x, plan, key)
    want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key, return_count=True)
    assert torch.equal(out, want_out)
    assert int(count) == int(want_count) >= 33 and int(count & 1) == int(want_count) & 1
    _, _, xb = _perm_words(n, (3,), 129, n + 2, dev)
    stacked = pb.stack_plans([Permutation(rng.permutation(n)).benes_plan() for _ in range(3)])
    assert torch.equal(_benes_on(path, "apply_benes_batch", xb, stacked)[0],
                       benes_kernels.apply_benes_batch_plain(xb, stacked))
    for name in ("apply_benes", "apply_benes_decrypt", "apply_benes_batch"):
        assert kernels.LAUNCHES[name] == before[name] + 1, name


def test_benes_forced_wide_path_equals_register_at_1247(dev):
    ctx, rng, x = _perm_words(1247, (), 1 << 16, 9, dev)
    p = Permutation(rng.permutation(1247))
    plan = p.benes_plan()
    key = _key(ctx, 9, "cpu").apply_permutation(p).mask_words.to(dev)
    x[:, ::7] |= core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), 1247)
    new = benes_kernels.apply_benes_decrypt(x, plan, key, return_count=True)
    old = _benes_on("wide", "apply_benes_decrypt", x, plan, key)
    assert torch.equal(new[0], old[0]) and int(new[1]) == int(old[1]) > 0
    assert torch.equal(benes_kernels.apply_benes(x, plan), _benes_on("wide", "apply_benes", x,
                                                                      plan)[0])


def test_benes_register_path_refuses_wide_networks(dev):
    """WP = 128 has no register instantiation: the launch is refused and
    raises, it does not fall back to another path."""
    _, rng, x = _perm_words(4095, (), 33, 4, dev)
    plan = Permutation(rng.permutation(4095)).benes_plan()
    assert benes_kernels.benes_path(plan.words_pad) == "lanes"
    with pytest.raises(RuntimeError, match="CUDA error"):
        _benes_on("register", "apply_benes", x, plan)


@pytest.mark.parametrize("chunks", [1 << 22, (1 << 22) + 37, 1 << 24, (1 << 24) + 37])
def test_benes_k8_at_millions_of_chunks_matches_the_reference(dev, chunks):
    """K8's register path at n = 1247 through `Ciphertext.apply_permutation`,
    up to a 4096 x 4096 product's 2^24 chunks and with a partial last block,
    against the benchmark's plain gather (portbench/reference/rekey.py),
    compared in blocks of 2^20 chunks."""
    gen = torch.Generator(device=dev).manual_seed(chunks)
    x = torch.randint(-2**31, 2**31, (CTX.words32, chunks), dtype=torch.int32, device=dev,
                      generator=gen)
    x &= words_from_numpy(CTX.valid_mask, dev)[:, None]
    perm = np.random.default_rng(chunks).permutation(CTX.n)
    p = Permutation(perm)
    assert benes_kernels.benes_path(p.benes_plan().words_pad) == "register"
    launches = benes_kernels.LAUNCHES["apply_benes"]
    got = Ciphertext(x, CTX).apply_permutation(p).wt
    assert benes_kernels.LAUNCHES["apply_benes"] > launches
    step = 1 << 20
    for c0 in range(0, chunks, step):
        assert torch.equal(got[:, c0:c0 + step], rekey.rotate(x[:, c0:c0 + step], perm)), c0


@pytest.mark.parametrize("n,k,chunks", [(1247, 3, 60001), (1247, 64, 1000), (1247, 700, 129),
                                        (100, 700, 33)])
def test_benes_k9_fleets_match_plain(dev, n, k, chunks):
    """K9 on fleets of 3 long elements, 64 of four blocks and 700 of one
    block, each element on one of five plans in a drawn order, against the
    plain batch."""
    _, rng, x = _perm_words(n, (k,), chunks, k + chunks, dev)
    pool = [Permutation(rng.permutation(n)).benes_plan() for _ in range(5)]
    stacked = pb.stack_plans([pool[i] for i in rng.integers(0, 5, size=k)])
    got = benes_kernels.apply_benes_batch(x, stacked)
    assert torch.equal(got, benes_kernels.apply_benes_batch_plain(x, stacked))


@pytest.mark.parametrize("batch,t1,t2", [(1, 3, 5), (4, 1, 1), (5, 13, 7), (3, 128, 130)])
def test_batched_k1_k3_match_2d_calls(dev, batch, t1, t2):
    sk = _key(CTX, batch + t1, dev)
    a = torch.stack([_words(CTX, t1, 10 * e + 1, dev, sk.mask, forced=range(e % 2, t1, 2))
                     for e in range(batch)])
    b = torch.stack([_words(CTX, t2, 10 * e + 2, dev, sk.mask, forced=range(0, t2, 3))
                     for e in range(batch)])
    m = sk.mask_words
    prod = kernels.mul_chunks(a, b)
    prod2, count = kernels.mul_decrypt(a, b, m, return_count=True)
    _, parity = kernels.mul_decrypt(a, b, m)
    assert torch.equal(prod, kernels.mul_chunks_plain(a, b)) and torch.equal(prod2, prod)
    dec = kernels.decrypt_parity(prod, m)
    matches = kernels.chunk_matches(prod, m)
    for e in range(batch):
        assert torch.equal(prod[e], kernels.mul_chunks(a[e], b[e]))
        want = int(kernels.mul_decrypt(a[e], b[e], m, return_count=True)[1])
        assert int(count[e]) == want and int(parity[e]) == want & 1 == int(dec[e])
        assert torch.equal(matches[e], kernels.chunk_matches(prod[e], m))
    assert torch.equal(dec, kernels.decrypt_parity_plain(prod, m))


def test_batches_past_the_grid_limit(dev):
    """More than 65535 elements take two grids (blockIdx.y is the element);
    every element past the first grid is still computed, and both grids
    count as launches."""
    batch = 65535 + 3
    sk = _key(SMALL, 2, dev)
    m = sk.mask_words
    a = torch.stack([_words(SMALL, 2, 1, dev, sk.mask, forced=(0,))] * batch)
    a[-1, :, 0] = 0     # the last element loses its forced match
    b = torch.stack([_words(SMALL, 3, 2, dev, sk.mask, forced=(1,))] * batch)
    before = dict(kernels.LAUNCHES)
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
    assert torch.equal(prod, kernels.mul_chunks_plain(a, b))
    assert torch.equal(count, kernels.mul_decrypt_plain(a, b, m, return_count=True)[1])
    assert int(count[-1]) == 0 < int(count[-2])
    assert torch.equal(kernels.decrypt_parity(prod, m), kernels.decrypt_parity_plain(prod, m))
    p = Permutation(np.random.default_rng(3).permutation(SMALL.n))
    got = benes_kernels.apply_benes(prod, p.benes_plan())
    assert torch.equal(got, benes_kernels.apply_benes_plain(prod, p.benes_plan()))
    # 2 x 3 = 6 product chunks per element: the multiply's unaligned mode.
    for name in ("mul_decrypt_unaligned_batched", "decrypt_parity_batched", "apply_benes"):
        assert kernels.LAUNCHES[name] == before[name] + 2, name


# ---------------------------------------------------------------------------
# The multiply's unaligned and b-streamed (tiled) modes
# ---------------------------------------------------------------------------

ODD_W = Context(150, 5)   # W = 6: element bases e*6*t1*t2 of a batch leave the 16-byte grid


def _check_mode(a, b, m, mode, batched=False):
    """Product and count of `mode` against the plain versions; the launch
    lands on the mode's own counter."""
    suffix = f"_{mode}" + ("_batched" if batched else "")
    before = dict(kernels.LAUNCHES)
    want = kernels.mul_chunks_plain(a, b)
    assert torch.equal(kernels.mul_chunks(a, b), want)
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
    _, want_count = kernels.mul_decrypt_plain(a, b, m, return_count=True)
    assert torch.equal(prod, want)
    assert torch.equal(count, want_count)
    _, parity = kernels.mul_decrypt(a, b, m)
    assert torch.equal(parity, want_count & 1)
    assert kernels.LAUNCHES["mul_chunks" + suffix] == before["mul_chunks" + suffix] + 1
    assert kernels.LAUNCHES["mul_decrypt" + suffix] == before["mul_decrypt" + suffix] + 2
    return count


@pytest.mark.parametrize("t1,t2", [(1, 1), (3, 1), (7, 3), (5, 37), (1, 5), (9, 1021),
                                   (3, 1030), (13, 16411)])
def test_unaligned_mode_matches_plain(dev, t1, t2):
    sk = _key(CTX, t1 + t2, dev)
    a = _words(CTX, t1, t1, dev, sk.mask, forced=range(0, t1, 2))
    b = _words(CTX, t2, t2 + 7, dev, sk.mask, forced=range(0, t2, 3))
    assert kernels.mul_mode(CTX.words32, t1, t2, True) == "unaligned"
    count = _check_mode(a, b, sk.mask_words, "unaligned")
    assert int(count) >= len(range(0, t1, 2)) * len(range(0, t2, 3))


@pytest.mark.parametrize("t1,t2", [(1, 7), (3, 8), (5, 1021), (2, 4096), (7, 2049)])
def test_tiled_mode_matches_plain(dev, monkeypatch, t1, t2):
    """b streamed tile by tile, aligned and unaligned products; the
    threshold is lowered so small shapes take the mode."""
    monkeypatch.setattr(kernels, "B_STREAM_BYTES", 64)
    sk = _key(CTX, t1 * t2, dev)
    a = _words(CTX, t1, t1, dev, sk.mask, forced=range(1, t1, 2) if t1 > 1 else (0,))
    b = _words(CTX, t2, t2 + 1, dev, sk.mask, forced=range(0, t2, 5))
    assert kernels.mul_mode(CTX.words32, t1, t2, True) == "tiled"
    _check_mode(a, b, sk.mask_words, "tiled")


def test_tiled_mode_past_the_threshold(dev):
    """b just past `B_STREAM_BYTES` at W = 40, unaligned (t1*t2 odd)."""
    t2 = kernels.B_STREAM_BYTES // (4 * CTX.words32) + 1
    sk = _key(CTX, 5, dev)
    a = _words(CTX, 3, 3, dev, sk.mask, forced=(0, 2))
    b = _words(CTX, t2, 4, dev, sk.mask, forced=range(0, t2, 1001))
    assert kernels.mul_mode(CTX.words32, 3, t2, True) == "tiled" and (3 * t2) % 4
    _check_mode(a, b, sk.mask_words, "tiled")


@pytest.mark.parametrize("mode", ["unaligned", "tiled"])
@pytest.mark.parametrize("batch,t1,t2", [(2, 1, 1), (5, 3, 7), (7, 13, 37), (3, 1, 1021)])
def test_batched_modes_with_misaligned_element_bases(dev, monkeypatch, mode, batch, t1, t2):
    """W = 6 and odd t1*t2: element e's base e*W*t1*t2 is off the 16-byte
    grid for odd e; each element equals its own 2-D product and count."""
    if mode == "tiled":
        monkeypatch.setattr(kernels, "B_STREAM_BYTES", 4 * ODD_W.words32 * t2 - 1)
    sk = _key(ODD_W, batch * t2, dev)
    a = torch.stack([_words(ODD_W, t1, 10 * e + 1, dev, sk.mask, forced=range(e % 2, t1, 2))
                     for e in range(batch)])
    b = torch.stack([_words(ODD_W, t2, 10 * e + 2, dev, sk.mask, forced=range(0, t2, 3))
                     for e in range(batch)])
    assert kernels.mul_mode(ODD_W.words32, t1, t2, True) == mode
    count = _check_mode(a, b, sk.mask_words, mode, batched=True)
    for e in range(batch):
        assert int(count[e]) == int(kernels.mul_decrypt(a[e], b[e], sk.mask_words,
                                                        return_count=True)[1])


@pytest.mark.parametrize("mode", ["unaligned", "tiled"])
def test_mode_batches_past_the_grid_limit(dev, monkeypatch, mode):
    """65538 elements: two grids, both counted; the last element's count
    (its forced match removed) is 0."""
    if mode == "tiled":
        monkeypatch.setattr(kernels, "B_STREAM_BYTES", 4 * SMALL.words32 * 3 - 1)
    batch = 65535 + 3
    sk = _key(SMALL, 4, dev)
    m = sk.mask_words
    a = torch.stack([_words(SMALL, 1, 1, dev, sk.mask, forced=(0,))] * batch)
    a[-1, :, 0] = 0
    b = torch.stack([_words(SMALL, 3, 2, dev, sk.mask, forced=(1,))] * batch)
    before = dict(kernels.LAUNCHES)
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
    assert torch.equal(prod, kernels.mul_chunks_plain(a, b))
    assert torch.equal(count, kernels.mul_decrypt_plain(a, b, m, return_count=True)[1])
    assert int(count[-1]) == 0 < int(count[-2])
    assert torch.equal(kernels.mul_chunks(a, b), prod)
    for name in (f"mul_decrypt_{mode}_batched", f"mul_chunks_{mode}_batched"):
        assert kernels.LAUNCHES[name] == before[name] + 2, name


def test_vec1_walk_still_matches_plain(dev):
    """The aligned walk with 4-byte stores (timed against the unaligned
    mode by chip_smoke.py) on an unaligned product."""
    sk = _key(CTX, 9, dev)
    a = _words(CTX, 5, 1, dev, sk.mask, forced=(0,))
    b = _words(CTX, 7, 2, dev, sk.mask, forced=(3,))
    prod, count = kernels._mul_cuda("mul_decrypt", a, b, sk.mask_words, mode="vec1")
    assert torch.equal(prod, kernels.mul_chunks_plain(a, b))
    assert int(count) == int(kernels.mul_decrypt_plain(a, b, sk.mask_words,
                                                       return_count=True)[1]) == 1


# ---------------------------------------------------------------------------
# The fused count: the mode's product kernel, then the column-match pass
# ---------------------------------------------------------------------------

# (mode, t1, t2): one pass block an element (t1 + t2 <= 1024) and several.
COUNT_SHAPES = [("aligned", 4, 8), ("aligned", 2048, 4), ("unaligned", 3, 5),
                ("unaligned", 1021, 17), ("tiled", 7, 3), ("tiled", 7, 2049),
                ("vec1", 5, 7), ("vec1", 1500, 3)]


def _fused(a, b, m, mode):
    """mul_decrypt's count in `mode` (vec1 forced, tiled by the threshold)."""
    if mode == "vec1":
        return kernels._mul_cuda("mul_decrypt", a, b, m, mode="vec1")
    return kernels.mul_decrypt(a, b, m, return_count=True)


def _set_matches(words, mask, cols):
    """Every column of `words` made to match the mask (cols "all") or to miss
    it (cols "none": the mask's bits cleared), in place."""
    m = torch.from_numpy(mask.view(np.int32)).to(words.device)[:, None]
    if cols == "all":
        words |= m
    else:
        words &= ~m
    return words


@pytest.mark.parametrize("matches", ["all", "none", "some"])
@pytest.mark.parametrize("mode,t1,t2", COUNT_SHAPES)
def test_count_pass_matches_plain_and_k3_in_every_mode(dev, monkeypatch, mode, t1, t2,
                                                       matches):
    """The fused count equals the plain version's and K3's count of
    `mul_chunks`' product; every chunk matching gives t1 * t2 and none 0.
    The pass counts one launch under mul_count per fused call and none per
    `mul_chunks` call, whose own counter the fused call leaves alone."""
    if mode == "tiled":
        monkeypatch.setattr(kernels, "B_STREAM_BYTES", 64)
    sk = _key(CTX, 31 * t1 + t2, dev)
    m = sk.mask_words
    a = _words(CTX, t1, t1 + 3, dev, sk.mask, forced=range(0, t1, 3))
    b = _words(CTX, t2, t2 + 4, dev, sk.mask, forced=range(1, t2, 2))
    if matches != "some":
        _set_matches(a, sk.mask, matches)
        _set_matches(b, sk.mask, matches)
    if mode != "vec1":
        assert kernels.mul_mode(CTX.words32, t1, t2, True) == mode
    before = dict(kernels.LAUNCHES)
    prod, count = _fused(a, b, m, mode)
    after_fused = dict(kernels.LAUNCHES)
    want_prod = kernels.mul_chunks(a, b)
    k3 = kernels.decrypt_parity(want_prod, m, return_count=True)
    _, plain = kernels.mul_decrypt_plain(a, b, m, return_count=True)
    assert torch.equal(prod, want_prod)
    assert int(count) == int(plain) == int(k3)
    if matches == "all":
        assert int(count) == t1 * t2
    elif matches == "none":
        assert int(count) == 0
    else:
        assert int(count) >= len(range(0, t1, 3)) * len(range(1, t2, 2)) > 0
    assert after_fused["mul_count"] == before["mul_count"] + 1
    assert after_fused["mul_chunks"] == before["mul_chunks"]
    moved = {k for k in after_fused if after_fused[k] != before[k]}
    assert len(moved) == 2 and "mul_count" in moved   # the product's key and the pass's
    assert kernels.LAUNCHES["mul_count"] == after_fused["mul_count"]   # mul_chunks: no pass


@pytest.mark.parametrize("mode,t1,t2", [s for s in COUNT_SHAPES if s[0] != "vec1"])
@pytest.mark.parametrize("batch", [3, 6])
def test_count_pass_batched_with_misaligned_element_bases(dev, monkeypatch, mode, t1, t2,
                                                         batch):
    """W = 6: odd elements' bases leave the 16-byte grid (aligned shapes
    included, whose batches still take the aligned mode when t1*t2 % 4 == 0).
    Element e matches everywhere, nowhere or in some columns by e % 3; each
    count equals the element's own 2-D count and K3's."""
    if mode == "tiled":
        monkeypatch.setattr(kernels, "B_STREAM_BYTES", 64)
    sk = _key(ODD_W, batch * t1 + t2, dev)
    m = sk.mask_words
    a = torch.stack([_words(ODD_W, t1, 10 * e + 1, dev, sk.mask, forced=range(e % 2, t1, 2))
                     for e in range(batch)])
    b = torch.stack([_words(ODD_W, t2, 10 * e + 2, dev, sk.mask, forced=range(0, t2, 3))
                     for e in range(batch)])
    for e in range(0, batch, 3):
        _set_matches(a[e], sk.mask, "all")
        _set_matches(b[e], sk.mask, "all")
    for e in range(1, batch, 3):
        _set_matches(b[e], sk.mask, "none")
    before = kernels.LAUNCHES["mul_count_batched"]
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
    assert kernels.LAUNCHES["mul_count_batched"] == before + 1
    assert torch.equal(prod, kernels.mul_chunks_plain(a, b))
    assert torch.equal(count, kernels.decrypt_parity(prod, m, return_count=True))
    for e in range(batch):
        assert int(count[e]) == int(kernels.mul_decrypt(a[e], b[e], m, return_count=True)[1])
    assert [int(count[e]) for e in range(0, batch, 3)] == [t1 * t2] * len(range(0, batch, 3))
    assert all(int(count[e]) == 0 for e in range(1, batch, 3))


@pytest.mark.parametrize("n,d,t1,t2", [(1247, 200, 1021, 17), (20000, 64, 3, 700),
                                        (70000, 16, 1030, 2)])
def test_count_pass_at_many_mask_words(dev, n, d, t1, t2):
    """Nearly every mask word nonzero (d = 200 at W = 40), and more mask words than
    the pass's threads (W = 626, 2188): the pass lists the nonzero rows in
    strides of its block and loads them in several groups."""
    ctx = Context(n, d)
    sk = _key(ctx, n + d, dev)
    m = sk.mask_words
    a = _words(ctx, t1, 1, dev, sk.mask, forced=range(0, t1, 2))
    b = _words(ctx, t2, 2, dev, sk.mask, forced=range(1, t2, 3))
    for words in (None, "all"):
        if words:
            _set_matches(a, sk.mask, words)
            _set_matches(b, sk.mask, words)
        prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
        _, plain = kernels.mul_decrypt_plain(a, b, m, return_count=True)
        assert torch.equal(prod, kernels.mul_chunks_plain(a, b))
        assert int(count) == int(plain) == int(kernels.decrypt_parity(prod, m,
                                                                      return_count=True))
        assert int(count) == (t1 * t2 if words else int(count)) > 0


def test_count_of_an_empty_product_is_zero_with_no_launch(dev):
    sk = _key(CTX, 17, dev)
    m = sk.mask_words
    full = _set_matches(_words(CTX, 5, 1, dev), sk.mask, "all")
    for a, b in ((full[:, :0], full), (full, full[:, :0]),
                 (full[None, :, :0].repeat(3, 1, 1), full[None].repeat(3, 1, 1))):
        # a freed all-match count first, so a block with nonzero bytes is at hand
        kernels.mul_decrypt(full, full, m, return_count=True)
        before = dict(kernels.LAUNCHES)
        prod, count = kernels.mul_decrypt(a.contiguous(), b.contiguous(), m, return_count=True)
        assert kernels.LAUNCHES == before
        assert prod.numel() == 0 and tuple(count.shape) == tuple(a.shape[:-2])
        assert not bool(count.any())


@pytest.mark.parametrize("t1,t2", [(4, 8), (3, 5), (2048, 4), (1021, 17)])
def test_count_is_written_not_accumulated(dev, t1, t2):
    """Fused calls in a row reuse the freed count block (and, with several
    pass blocks, the freed scratch): each count is its own call's."""
    sk = _key(CTX, t1 * t2, dev)
    m = sk.mask_words
    hit = [_set_matches(_words(CTX, t, t, dev), sk.mask, "all") for t in (t1, t2)]
    miss = [_set_matches(_words(CTX, t, t + 1, dev), sk.mask, "none") for t in (t1, t2)]
    want = [t1 * t2, 0, t1 * t2, t1 * t2, 0]
    for pair, w in zip((hit, miss, hit, hit, miss), want):
        _, count = kernels.mul_decrypt(*pair, m, return_count=True)
        assert int(count) == w
        del count
    batch = 4
    bh = [x[None].repeat(batch, 1, 1) for x in hit]
    for k in range(3):
        _, count = kernels.mul_decrypt(*bh, m, return_count=True)
        assert count.tolist() == [t1 * t2] * batch, k
        del count


def test_count_pass_past_the_grid_limit_with_several_blocks(dev):
    """65538 elements of 1 x 1030 (two pass blocks an element): two grids of
    the pass, each element's scratch its own."""
    batch, t2 = 65535 + 3, 1030
    sk = _key(SMALL, 6, dev)
    m = sk.mask_words
    a = _set_matches(_words(SMALL, 1, 1, dev), sk.mask, "all")[None].repeat(batch, 1, 1)
    b = _words(SMALL, t2, 2, dev, sk.mask, forced=range(0, t2, 7))[None].repeat(batch, 1, 1)
    a[::3, :, 0] = 0                                   # these elements count 0
    b[1::2, :, :500] = 0                               # these fewer
    a[-1, :, 0] = 0
    before = dict(kernels.LAUNCHES)
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
    assert kernels.LAUNCHES["mul_count_batched"] == before["mul_count_batched"] + 2
    assert torch.equal(count, kernels.decrypt_parity(prod, m, return_count=True))
    na = kernels.chunk_matches(a, m).sum(-1)
    nb = kernels.chunk_matches(b, m).sum(-1)
    assert torch.equal(count, na * nb)
    assert int(count[-1]) == 0 < int(count[-2]) and int(count[-3]) == 0
    assert len(set(count.tolist())) == 3
    assert torch.equal(prod[-2:], kernels.mul_chunks_plain(a[-2:], b[-2:]))


def test_count_pass_builds_without_spills(dev):
    """The pass compiles to one kernel with no spills, and the product
    kernels have only their product forms: (kVec 1, 4) and (streamed or
    not), each 2-D and batched."""
    from csgn_tpu_torch.ops import _build

    rows = _build.kernel_resources()
    count = [r for r in rows if "match_count_kernel" in r["kernel"]]
    assert len(count) == 1, count
    assert count[0]["spill_stores"] == count[0]["spill_loads"] == 0, count
    assert len([r for r in rows if "mul_kernelI" in r["kernel"]]) == 4
    assert len([r for r in rows if "mul_ragged_kernelI" in r["kernel"]]) == 4


def test_chain_circuit_and_serve_on_card_equal_cpu(dev):
    """mul_chain(_decrypt), a fleet DAG readout and the executor's routes on
    the card give the CPU path's words and bits."""
    from csgn_tpu_torch import BatchExecutor, pipeline
    from csgn_tpu_torch.circuit import lift
    from csgn_tpu_torch.models import netlist as nl

    idx = np.random.default_rng(2).choice(CTX.n, CTX.d, replace=False)
    out = {}
    for device in ("cpu", dev):
        sk = SecretKey(CTX, idx, device)
        cts = [Ciphertext(sk.encrypt_batch(b, 20 + k), CTX)
               for k, b in enumerate([[1, 0, 0], [1, 1, 1, 0, 0], [0, 1, 0]])]
        chain, bit = pipeline.mul_chain_decrypt(cts, sk)
        fleet = CiphertextBatch.stack([cts[0], cts[2]])
        dag = sk.decrypt_circuit(lift(fleet) * fleet + cts[1])
        ex = BatchExecutor(sk, rng=rng.key(4))
        add = ex.submit_netlist(nl.adder(2), [[cts[0], cts[1]], [cts[2], cts[0]]])
        enc = ex.submit_encrypt(1)
        md = ex.submit_mul_decrypt(cts[0], cts[1])
        out[str(device)] = (pipeline.mul_chain(cts).to_u64(), chain.to_u64(), int(bit),
                            dag.tolist(), [c.to_u64() for c in add.result()[0]],
                            enc.result().to_u64(), md.result()[0].to_u64(), md.result()[1])
    cpu, gpu = out["cpu"], out[str(dev)]
    for x, y in zip(cpu, gpu):
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    assert cpu[2] == 1 and cpu[7] == 1


# ---------------------------------------------------------------------------
# The Philox engine (K7), its stream dump (K13) and the write anchor (K5)
# ---------------------------------------------------------------------------


def _philox_operands(w, d, dev, seed):
    """Key operands at any W (W = 3 has no Context: a raw 3-word mask)."""
    n = 32 * w - 1
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, d, replace=False).astype(np.int32)
    from csgn_tpu_torch.layout import bit_positions_to_mask

    mask = bit_positions_to_mask(idx, n)[:w]
    valid = bit_positions_to_mask(np.arange(n), n)[:w]
    return (torch.from_numpy(idx).to(dev), words_from_numpy(mask, dev),
            words_from_numpy(valid, dev))


@pytest.mark.parametrize("w", [3, 4, 7, 40, 128])
@pytest.mark.parametrize("d", [4, 16, 32])
@pytest.mark.parametrize("batch", [1, 255, 257, 4099])
def test_philox_k7_k13_match_plain(dev, w, d, batch):
    """Rows W and W + 1 straddle two Philox groups at W % 4 == 3."""
    ops = _philox_operands(w, d, dev, w * 100 + d)
    bits = torch.from_numpy(np.random.default_rng(batch).integers(0, 2, batch)).to(dev)
    seed = (0xC0FFEE << 32) | batch
    got = encrypt_kernels.encrypt_bits_philox(seed, bits, *ops)
    assert torch.equal(got, encrypt_kernels.encrypt_bits_philox_plain(seed, bits, *ops))
    m = ops[1]
    assert torch.equal(kernels.chunk_matches(got, m), bits.to(torch.int32))
    assert not (got & ~ops[2][:, None]).any()
    rows = encrypt_kernels.philox_streams(seed, batch, w + 2, dev)
    want = encrypt_kernels.philox_streams_plain(seed, batch, w + 2, dev).to(torch.int32)
    assert torch.equal(rows, want)
    assert torch.equal(encrypt_kernels.derive_words(rows.long() & 0xFFFFFFFF, bits, *ops), got)


@pytest.mark.parametrize("w", [3, 4, 7, 40, 128])
@pytest.mark.parametrize("d", [4, 16, 32])
@pytest.mark.parametrize("batch", [1, 255, 257, 4099])
@pytest.mark.parametrize("col0", [0, 4099])
def test_threefry_k14_matches_plain(dev, w, d, batch, col0):
    """K14 at columns [col0, col0 + batch) of a batch + col0-column encrypt:
    its plain version's words, the bits back, the padding bits zero."""
    ops = _philox_operands(w, d, dev, w * 100 + d)
    bits = torch.from_numpy(np.random.default_rng(batch).integers(0, 2, batch)).to(dev)
    key = rng.key((w << 20) + batch)
    before = encrypt_kernels.LAUNCHES["encrypt_bits_threefry"]
    got = encrypt_kernels.encrypt_bits_threefry(key, bits, *ops, col0=col0, total=col0 + batch)
    assert encrypt_kernels.LAUNCHES["encrypt_bits_threefry"] == before + 1
    assert torch.equal(got, encrypt_kernels.encrypt_bits_threefry_plain(
        key, bits, *ops, col0=col0, total=col0 + batch))
    assert torch.equal(kernels.chunk_matches(got, ops[1]), bits.to(torch.int32))
    assert not (got & ~ops[2][:, None]).any()


def test_default_engine_through_the_key_on_card_equals_cpu(dev):
    """`encrypt_batch` under an rng.Key on the card: the CPU path's words
    (held to csgn_tpu by the CPU tests)."""
    bits = np.random.default_rng(7).integers(0, 2, 3000).astype(np.int32)
    cpu = SecretKey.generate(CTX, rng.key(7), "cpu")
    gpu = SecretKey.generate(CTX, rng.key(7), dev)
    assert np.array_equal(cpu.indices, gpu.indices)
    assert torch.equal(gpu.encrypt_batch(bits, rng.key(8)).cpu(),
                       cpu.encrypt_batch(bits, rng.key(8)))


PHILOX_T = encrypt_kernels.PHILOX_TILE_COLS
PHILOX_WIDE = encrypt_kernels.PHILOX_TILE_MAX_WORDS + 4     # past the tile path: the column path


def _philox_key_operands(w, n, dev):
    """W = 32 at n = 1024 through a Context (all-ones valid mask); else raw
    operands at n = 32 W - 1."""
    if n == 1024:
        ctx = Context(n, 16)
        return SecretKey(ctx, np.random.default_rng(n).choice(n, 16, replace=False),
                         dev).encrypt_operands
    return _philox_operands(w, 16, dev, w * 100 + 16)


@pytest.mark.parametrize("w,n", [(32, 1023), (32, 1024), (40, 1247), (128, 4095),
                                 (PHILOX_WIDE, 32 * PHILOX_WIDE - 1)])
@pytest.mark.parametrize("batch", [PHILOX_T - 1, PHILOX_T, PHILOX_T + 1, 2 * PHILOX_T + 3, 4096])
@pytest.mark.parametrize("col0", [0, 5])
def test_philox_k7_paths_match_plain(dev, w, n, batch, col0):
    """K7 on the path its shape takes (16-byte or 4-byte tile row stores, or
    the column path past the tile's width) at the tile's edges and past
    them, counted under that path."""
    ops = _philox_key_operands(w, n, dev)
    bits = torch.from_numpy(np.random.default_rng(batch + col0).integers(0, 2, batch)).to(dev)
    seed = (0xBADC0DE << 32) | (batch + col0)
    path = encrypt_kernels.philox_path(w, batch)
    key = {"tile": "philox_tile", "tile_4byte": "philox_tile_4byte", "column": "philox_column"}
    before = dict(encrypt_kernels.LAUNCHES)
    got = encrypt_kernels.encrypt_bits_philox(seed, bits, *ops, col0=col0)
    assert encrypt_kernels.LAUNCHES[key[path]] == before[key[path]] + 1
    assert torch.equal(got, encrypt_kernels.encrypt_bits_philox_plain(seed, bits, *ops,
                                                                      col0=col0))
    assert not (got & ~ops[2][:, None]).any()


@pytest.mark.parametrize("w", [32, 40, 128])
@pytest.mark.parametrize("batch", [PHILOX_T + 1, 4096, 1 << 20])
def test_philox_k7_forced_paths_agree(dev, w, batch):
    """Each path of K7 forced at a W that all take writes the plain words."""
    ops = _philox_key_operands(w, 32 * w - 1, dev)
    bits = torch.from_numpy(np.random.default_rng(w).integers(0, 2, batch)).to(dev)
    want = encrypt_kernels.encrypt_bits_philox_plain(77, bits, *ops)
    for path in ("tile", "tile_4byte", "column"):
        if path == "tile" and batch % 4:
            continue                             # 16-byte row stores need batch % 4 == 0
        assert torch.equal(encrypt_kernels._philox_cuda(77, bits, *ops, path=path), want), path


def test_philox_k7_tile_refuses_shapes_it_cannot_take(dev):
    ops = _philox_key_operands(40, 1247, dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        encrypt_kernels._philox_cuda(1, torch.ones(7, dtype=torch.int32, device=dev), *ops,
                                     path="tile")
    wide = _philox_key_operands(PHILOX_WIDE, 32 * PHILOX_WIDE - 1, dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        encrypt_kernels._philox_cuda(1, torch.ones(8, dtype=torch.int32, device=dev), *wide,
                                     path="tile_4byte")


def test_philox_engine_through_the_key_on_card_equals_cpu(dev):
    idx = np.random.default_rng(4).choice(CTX.n, CTX.d, replace=False)
    bits = np.random.default_rng(5).integers(0, 2, 1000)
    out = [SecretKey(CTX, idx, device).encrypt_batch(bits, 77, engine="philox").cpu()
           for device in ("cpu", dev)]
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("t1,t2,w", [(1, 1, 40), (4, 4, 40), (3, 5, 40), (1021, 16411, 4),
                                     (64, 64, 128), (7, 9, 1), (1, 3, 1), (1021, 16411, 3)])
def test_fill_anchor_k5_matches_plain(dev, t1, t2, w):
    """C % 4 != 0, W*C below one block, and W*C % 4 != 0 (the words after the
    last 16-byte store), up to about 12,000 blocks of 16 KB (201 MB) plus
    the W*C % 4 tail words."""
    before = kernels.LAUNCHES["fill_anchor"]
    got = kernels.fill_anchor(0x1_8000_0001, t1, t2, w, dev)
    assert torch.equal(got, kernels.fill_anchor_plain(0x1_8000_0001, t1, t2, w, dev))
    assert kernels.LAUNCHES["fill_anchor"] == before + 1


# ---------------------------------------------------------------------------
# The Beneš kernel's lane-group path (64 < WP <= 2048) and wide path
# ---------------------------------------------------------------------------

LANE_NS = [2049, 4095, 8191, 16383, 16385, 20000, 40000]   # WP = 128 ... 2048
WIDE_NS = [16385, 20000, 40000, 70000]   # WP = 1024, 1024, 2048, 4096


@functools.cache
def _wide_perms(n):
    """Three permutations of n bits with their plans routed (cached: routing
    takes seconds on the host at these n)."""
    rng = np.random.default_rng(n)
    perms = [Permutation(rng.permutation(n)) for _ in range(3)]
    for q in perms:
        q.benes_plan()
    return perms


def _wide_case(n, lead, chunks, dev):
    ctx, _, x = _perm_words(n, lead, chunks, n + chunks, dev)
    return ctx, x


def _k8_k9_k12_on(path, n, chunks, dev):
    """K8, K12 (count and parity) and K9 (two plans) on `path` (None: the
    routed one) against their plain versions; returns the wrappers' launches."""
    p, q, r = _wide_perms(n)
    plan = p.benes_plan()
    ctx, x = _wide_case(n, (), chunks, dev)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(_benes_on(path, "apply_benes", x, plan)[0],
                       benes_kernels.apply_benes_plain(x, plan))
    key = _key(ctx, n, "cpu").apply_permutation(p).mask_words.to(dev)
    x[:, 0:chunks:3] |= core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
    out, count = _benes_on(path, "apply_benes_decrypt", x, plan, key)
    want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key,
                                                                   return_count=True)
    assert torch.equal(out, want_out)
    assert int(count) == int(want_count) >= len(range(0, chunks, 3))
    if path is None:
        assert int(benes_kernels.apply_benes_decrypt(x, plan, key)[1]) == int(want_count) & 1
    _, xb = _wide_case(n, (2,), chunks, dev)
    stacked = pb.stack_plans([q.benes_plan(), r.benes_plan()])
    assert torch.equal(_benes_on(path, "apply_benes_batch", xb, stacked)[0],
                       benes_kernels.apply_benes_batch_plain(xb, stacked))
    return {k: kernels.LAUNCHES[k] - before[k] for k in before}


@pytest.mark.parametrize("n", LANE_NS)
@pytest.mark.parametrize("chunks", [1, 129, 1000, 1025])
def test_benes_lanes_k8_k9_k12_match_plain(dev, n, chunks):
    """K8, K12 and K9 routed to the lane-group path at every width it takes,
    over chunk counts that are not multiples of a warp's or a block's
    chunks."""
    wp = _wide_perms(n)[0].benes_plan().words_pad
    assert benes_kernels.benes_path(wp) == "lanes"
    launched = _k8_k9_k12_on(None, n, chunks, dev)
    assert launched["benes_lanes"] == 4 and launched["benes_wide"] == 0
    for name, k in (("apply_benes", 1), ("apply_benes_decrypt", 2), ("apply_benes_batch", 1)):
        assert launched[name] == k, name


@pytest.mark.parametrize("n", [4095, 20000, 40000])
def test_benes_lanes_zero_stage_plans(dev, n):
    """The identity (every stage off) and a transposition (most stages off)
    on the lane-group path: the plan staged in shared memory (WP = 128 and
    1024) and read through L1 (WP = 2048)."""
    _, _, x = _perm_words(n, (), 300, 5, dev)
    swap = np.arange(n)
    swap[3], swap[n - 7] = swap[n - 7], swap[3]
    for p in (Permutation.identity(n), Permutation(swap)):
        assert torch.equal(_benes_on("lanes", "apply_benes", x, p.benes_plan())[0],
                           benes_kernels.apply_benes_plain(x, p.benes_plan()))
    assert torch.equal(_benes_on("lanes", "apply_benes", x,
                                 Permutation.identity(n).benes_plan())[0], x)


@pytest.mark.parametrize("n", WIDE_NS)
@pytest.mark.parametrize("chunks", [4096, 1000])
def test_benes_wide_path_k8_k9_k12_match_plain(dev, n, chunks):
    """K8, K12 (count) and K9 on the wide path, bit-equal to their plain
    versions, at 4,096 chunks and at 1,000 (not a multiple of the 32-column
    tile): routed there at n = 70000, forced at the lane-group path's
    widths."""
    wp = _wide_perms(n)[0].benes_plan().words_pad
    assert benes_kernels.benes_path(wp) == ("wide" if n > 65536 else "lanes")
    launched = _k8_k9_k12_on("wide", n, chunks, dev)
    assert launched["benes_wide"] == 3 and launched["benes_lanes"] == 0
    for name in ("apply_benes", "apply_benes_decrypt", "apply_benes_batch"):
        assert launched[name] == 1, name


def test_benes_wide_path_one_column_a_thread(dev):
    """n = 140000 (WP = 8192): the tile holds two columns a block, so each
    thread works on one column (the V = 1 form), for K8 and K12."""
    n = 140000
    ctx, rng, x = _perm_words(n, (), 100, 7, dev)
    p = Permutation(rng.permutation(n))
    plan = p.benes_plan()
    assert plan.words_pad == 8192 and benes_kernels.benes_path(plan.words_pad) == "wide"
    assert torch.equal(benes_kernels.apply_benes(x, plan),
                       benes_kernels.apply_benes_plain(x, plan))
    key = _key(ctx, n, "cpu").apply_permutation(p).mask_words.to(dev)
    x[:, 0:100:3] |= core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
    out, count = benes_kernels.apply_benes_decrypt(x, plan, key, return_count=True)
    want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key,
                                                                   return_count=True)
    assert torch.equal(out, want_out) and int(count) == int(want_count) >= 34


@pytest.mark.parametrize("n", [20, 1247, 4095, 20000])
def test_benes_wide_and_global_forms_match_plain(dev, n):
    """The wide path forced onto narrow networks (n < 32 included), and its
    global-scratch form (taken past 32,768 words) forced at n <= 20000."""
    ctx, rng, x = _perm_words(n, (), 129, n + 3, dev)
    p = Permutation(rng.permutation(n))
    plan = p.benes_plan()
    key = _key(ctx, n, "cpu").apply_permutation(p).mask_words.to(dev)
    x[:, 0:129:4] |= core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
    want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key,
                                                                   return_count=True)
    _, _, xb = _perm_words(n, (3,), 129, n + 4, dev)
    stacked = pb.stack_plans([Permutation(rng.permutation(n)).benes_plan() for _ in range(3)])
    for path in ("wide", "global"):
        assert torch.equal(_benes_on(path, "apply_benes", x, plan)[0], want_out)
        out, count = _benes_on(path, "apply_benes_decrypt", x, plan, key)
        assert torch.equal(out, want_out) and int(count) == int(want_count) >= 33
        assert torch.equal(_benes_on(path, "apply_benes_batch", xb, stacked)[0],
                           benes_kernels.apply_benes_batch_plain(xb, stacked))


def test_benes_wide_path_through_the_api(dev):
    """Context(20000, 16), on the lane-group path: a ciphertext permuted on
    the card, decrypted under the permuted key (1), and permuted back; a
    fleet re-keyed per element."""
    before = kernels.LAUNCHES["benes_lanes"]
    ctx = Context(20000, 16)
    sk = _key(ctx, 5, dev)
    p, q, _ = _wide_perms(20000)
    c = Ciphertext(sk.encrypt_batch([1, 0, 0, 1, 1], 9), ctx)
    rot = c.apply_permutation(p)
    assert int(sk.apply_permutation(p).decrypt(rot)) == 1
    _, parity = sk.permute_and_decrypt(c, p)
    assert int(parity) == 1
    assert torch.equal(rot.apply_permutation(p.inverse()).wt, c.wt)
    fleet = CiphertextBatch.stack([c, Ciphertext(sk.encrypt_batch([0, 1, 1, 1, 0], 10), ctx)])
    got = fleet.apply_permutations([p, q])
    assert [int(sk.apply_permutation(x).decrypt(got[i])) for i, x in enumerate((p, q))] == [1, 1]
    assert kernels.LAUNCHES["benes_lanes"] >= before + 4


# ---------------------------------------------------------------------------
# The reference's golden vectors through K1, K3 and K8
# ---------------------------------------------------------------------------

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden_vectors.json"


@pytest.mark.parametrize("which", [0, 1, 2], ids=["n1247", "n95", "n4095"])
def test_golden_vectors_through_the_kernels(dev, which):
    """The golden add, mul (K1), decrypt (K3) and permutation (K8: register
    path at n = 95 and 1247, lane-group path at 4095) vectors dumped from the C++
    reference, on the card."""
    sc = json.loads(GOLDEN.read_text())["scenarios"][which]
    ctx = Context(sc["n"], sc["d"])

    def ct(name):
        return Ciphertext.from_u64(np.array([int(v) for v in sc[name]], dtype=np.uint64),
                                   ctx, dev)

    def u64(name):
        return np.array([int(v) for v in sc[name]], dtype=np.uint64)

    before = dict(kernels.LAUNCHES)
    c1, c0 = ct("c1"), ct("c0")
    added = c1 + c0
    got = {"added": added, "multiplied": c1 * c0, "big": added * added}
    got["bigger"] = got["big"] * added
    got["biggest"] = got["bigger"] * added
    for name, c in got.items():
        np.testing.assert_array_equal(c.to_u64(), u64(name), err_msg=name)
    sk = SecretKey(ctx, np.array(sc["key"], dtype=np.int32), dev)
    for name, c in dict(got, c1=c1, c0=c0).items():
        assert int(sk.decrypt(c)) == sc["dec"][name], name
    p = Permutation(np.array(sc["perm"], dtype=np.int32))
    pc1 = c1.apply_permutation(p)
    np.testing.assert_array_equal(pc1.to_u64(), u64("permuted_c1"))
    assert int(sk.apply_permutation(p).decrypt(pc1)) == sc["dec"]["permuted_c1"]
    path = benes_kernels.benes_path(p.benes_plan().words_pad)
    assert path == ("lanes" if sc["n"] == 4095 else "register")
    for name in ("mul_chunks", "decrypt_parity", "apply_benes"):
        assert kernels.LAUNCHES[name] > before[name], name


# ---------------------------------------------------------------------------
# The encrypt engines' global column base
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["counter", "philox"])
@pytest.mark.parametrize("col0,batch", [(1, 5), (255, 257), (4096, 4099)])
def test_encrypt_col0_is_a_slice_of_the_col0_zero_launch(dev, engine, col0, batch):
    sk = _key(CTX, 3, dev)
    fn = {"counter": encrypt_kernels.encrypt_bits_counter,
          "philox": encrypt_kernels.encrypt_bits_philox}[engine]
    plain = {"counter": encrypt_kernels.encrypt_bits_counter_plain,
             "philox": encrypt_kernels.encrypt_bits_philox_plain}[engine]
    bits = torch.from_numpy(np.random.default_rng(col0).integers(0, 2, col0 + batch)
                            .astype(np.int32)).to(dev)
    whole = fn(99, bits, *sk.encrypt_operands)
    got = fn(99, bits[col0:], *sk.encrypt_operands, col0=col0)
    assert torch.equal(got, whole[:, col0:])
    assert torch.equal(got, plain(99, bits[col0:], *sk.encrypt_operands, col0=col0))


# ---------------------------------------------------------------------------
# The multi-device layer at world size 1, over NCCL
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_world(dev, tmp_path):
    import torch.distributed as dist

    from csgn_tpu_torch import parallel

    parallel.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    assert dist.get_backend() == "nccl"
    try:
        yield parallel
    finally:
        dist.destroy_process_group()


def test_sharded_ops_at_world_size_one_equal_the_unsharded_calls(dev, nccl_world, tmp_path):
    from csgn_tpu_torch import io as cio
    from csgn_tpu_torch.parallel import dryrun
    from csgn_tpu_torch.pipeline import mul_chain_decrypt, mul_chain_sharded_decrypt

    par = nccl_world
    mesh = par.chunk_mesh()
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    sk = _key(CTX, 11, dev)
    m = sk.mask_words
    a = Ciphertext(sk.encrypt_batch(np.arange(1000) % 2 == 0, 1), CTX)
    b = Ciphertext(sk.encrypt_batch(np.arange(37) % 3 == 0, 2), CTX)
    c = Ciphertext(sk.encrypt_batch([1, 0, 1], 3), CTX)
    prod = a * b
    assert torch.equal(par.sharded_mul_allgather(a.wt, b.wt, mesh), prod.wt)
    assert torch.equal(par.sharded_mul_ring(a.wt, b.wt, mesh), prod.wt)
    assert torch.equal(par.sharded_mul_broadcast(a.wt, b.wt, mesh), prod.wt)
    words, parity = par.sharded_mul_decrypt(a.wt, b.wt, m, mesh)
    _, want = sk.mul_and_decrypt(a, b)
    assert torch.equal(words, prod.wt) and int(parity) == int(want)
    assert int(par.sharded_decrypt_parity(prod.wt, m, mesh)) == int(sk.decrypt(prod))
    p = Permutation.random(CTX, rng.key(3))
    assert torch.equal(par.sharded_permute(prod.wt, p.benes_plan(), mesh),
                       prod.apply_permutation(p).wt)
    bits = torch.from_numpy((np.arange(300) % 5 == 0).astype(np.int32)).to(dev)
    enc = par.sharded_encrypt_bits(4, bits, *sk.encrypt_operands, CTX.n, CTX.d, mesh)
    assert torch.equal(enc, sk.encrypt_batch(bits, 4))
    enc = par.sharded_encrypt_bits(rng.key(4), bits, *sk.encrypt_operands, CTX.n, CTX.d, mesh)
    assert torch.equal(enc, sk.encrypt_batch(bits, rng.fold_in(rng.key(4), 0)))
    enc = par.sharded_encrypt_bits_invariant(rng.key(4), bits, *sk.encrypt_operands, CTX.n,
                                             CTX.d, mesh)
    assert torch.equal(enc, sk.encrypt_batch(bits, rng.key(4)))
    chain, cp = mul_chain_sharded_decrypt([a, b, c], sk, mesh)
    want_chain, want_p = mul_chain_decrypt([a, b, c], sk)
    assert torch.equal(chain.wt, want_chain.wt) and int(cp) == int(want_p)
    mesh2 = par.batch_chunk_mesh(1, 1)
    fleet = torch.stack([a.wt, a.wt])
    blk = par.shard_batch(fleet, mesh2)
    pb2 = par.sharded_mul_batch(blk, blk, mesh2)
    assert torch.equal(pb2, kernels.mul_chunks(fleet, fleet))
    assert torch.equal(par.sharded_decrypt_batch(pb2, m, mesh2),
                       sk.decrypt_batch(pb2))
    par_dir = tmp_path / "ckpt"
    cio.save_state_sharded(par_dir, {"prod": prod, "sk": sk}, mesh)
    back = cio.load_state_sharded(par_dir, mesh=mesh)
    assert torch.equal(back["prod"].wt, prod.wt) and back["prod"].wt.is_cuda
    assert dryrun.run(workdir=tmp_path)["parity"] == 1


# ---------------------------------------------------------------------------
# The user programs on the card
# ---------------------------------------------------------------------------


def test_validate_sweep_and_fault_demo_resume_on_card(dev, capsys):
    """The validate sweep at its full shapes, every kernel against its plain
    version on the card, and the fault demo: two gloo ranks on the CPU, the
    last killed mid-step, the resume on the card bit-equal to the oracle."""
    from csgn_tpu_torch.tools import validate

    assert validate.main() == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "FAILS: none" and "[plain]" not in out
    repo = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-m", "csgn_tpu_torch.tools.fault_demo", "--nproc",
                          "2"], cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "killed worker 1 of 2" in res.stdout and "fault demo: OK" in res.stdout
    assert "on 1 rank (cuda:0): words_exact=True" in res.stdout


# ---------------------------------------------------------------------------
# The benchmark program on the card
# ---------------------------------------------------------------------------


def test_bench_program_on_card(dev, monkeypatch):
    """`csgn_tpu_torch.bench.run` on the card: the keys of the JAX package's
    bench.py line (read from its source), every guard passed (the program
    raises otherwise) and readings a right run can give; then a wrong fused
    parity is caught by the product guard."""
    import ast

    from csgn_tpu_torch import bench

    line = bench.run(dev)
    tree = ast.parse((pathlib.Path(__file__).resolve().parent.parent / "bench.py").read_text())
    keys = next({k.value for k in node.keys} for node in ast.walk(tree)
                if isinstance(node, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys))
    assert set(line) == keys
    assert line["value"] > 0 and line["value_vs_anchor"] <= 1.05 and line["groups"] >= 4
    assert line["enc_suspect"] is False and line["perm_block_c"] is None
    assert line["aes_fleet_blocks_per_s"] > 0

    right = kernels.mul_decrypt

    def wrong(a, b, mask, **kw):
        prod, parity = right(a, b, mask, **kw)
        return prod, parity ^ 1

    monkeypatch.setattr(kernels, "mul_decrypt", wrong)
    with pytest.raises(bench.BenchFailure, match="fused parity"):
        bench.check_product(_words(CTX, 16, 1, dev), _words(CTX, 256, 2, dev),
                            _key(CTX, 3, dev).mask_words)


@pytest.mark.parametrize("t1,t2", [(16, 1 << 19), (20, 300000), (17, (1 << 19) + 1)])
def test_streamed_product_is_canonical_and_jmajor_canonicalizes(dev, t1, t2):
    """Where b streams, `*` and `mul_and_decrypt` stay on the canonical
    tiled route; the j-major product of the same operands
    (`mul_chunks_jmajor`, tagged) resolves to the canonical kernel's words,
    decrypts to the canonical parity, and keeps its tag right through
    permute and add."""
    from csgn_tpu_torch.ops import dispatch, order

    sk = _key(CTX, t1, dev)
    a = Ciphertext(_words(CTX, t1, 1, dev, sk.mask, forced=range(0, t1, 3)), CTX)
    b = Ciphertext(_words(CTX, t2, 2, dev, sk.mask, forced=range(0, t2, 1001)), CTX)
    before = kernels.LAUNCHES["mul_decrypt_tiled"]
    prod = a * b
    prod2, parity = sk.mul_and_decrypt(a, b)
    assert prod.is_canonical and prod2.is_canonical
    assert kernels.LAUNCHES["mul_decrypt_tiled"] == before + 1
    want, want_parity = kernels.mul_decrypt(a.wt, b.wt, sk.mask_words)
    assert torch.equal(prod.wt, want) and torch.equal(prod2.wt, want)
    assert int(parity) == int(want_parity) == int(core.decrypt_parity(want, sk.mask_words))
    jm = Ciphertext(dispatch.mul_chunks_jmajor(a.wt, b.wt), CTX,
                    order.cross_logical(None, None, t1, t2, jmajor=True, device=dev))
    assert not jm.is_canonical and torch.equal(jm.wt, kernels.mul_chunks(b.wt, a.wt))
    assert torch.equal(jm.canonical().wt, want) and int(sk.decrypt(jm)) == int(want_parity)
    p = Permutation.random(CTX, rng.key(t1))
    assert torch.equal(jm.apply_permutation(p).canonical().wt,
                       benes_kernels.apply_benes(want, p.benes_plan()))
    s = jm + a
    assert torch.equal(s.canonical().wt, torch.cat([want, a.wt], dim=1))
