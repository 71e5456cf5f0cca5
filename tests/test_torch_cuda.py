"""The port on the card: its CUDA kernels against their plain torch
versions, and its paths through the public API at full size.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor csgn_tpu, so it runs where only torch is installed (JAX's
draws come from tests/torch_jax_draws.py):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)  Equality is
exact: the kernels are integer code.
"""

import functools
import hashlib
import hmac
import json
import operator
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from csgn_tpu_torch import (BatchExecutor, Ciphertext, CiphertextBatch, Context, Permutation,
                            SecretKey, rng)
from csgn_tpu_torch import serve
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.ops import benes_kernels, dispatch, encrypt_kernels, kernels
from csgn_tpu_torch.ops import core
from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.utils.metrics import op_metrics
from portbench.inputs import fresh_chunks, host_rng, key_positions
from portbench.reference import csgn, fleet, rekey

import torch_jax_draws as draws

pytestmark = pytest.mark.cuda

SKIP_REASON = "needs an NVIDIA GPU"
CTX = Context(1247, 16)
SMALL = Context(95, 4)
# FIPS-197 appendix C.1: AES-128 key, plaintext, ciphertext.
FIPS197_C1 = ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
              "69c4e0d86a7b0430d8cdb78070b4c55a")


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


def _path(name, launches):
    """Marks a test as a run of the public path `name` at full size
    (chip_smoke.py runs the tests so marked, path by path) and fails it
    unless its calls counted a launch under each LAUNCHES key of
    `launches`: a tuple, or a function of the case's parameters giving one."""
    def mark(test):
        @functools.wraps(test)
        def run(**case):
            keys = launches(**case) if callable(launches) else launches
            before = dict(kernels.LAUNCHES)
            test(**case)
            idle = [k for k in keys if kernels.LAUNCHES[k] == before[k]]
            assert not idle, f"the {name} path counted no launch under {idle}"
        run.path = name
        return run
    return mark


@pytest.mark.parametrize("ctx", [CTX, SMALL], ids=["1247x16", "95x4"])
@pytest.mark.parametrize("t1,t2", [(1, 1), (3, 5), (13, 7), (9, 33), (4, 128), (128, 130),
                                   (4096, 4096)])
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


@pytest.mark.parametrize("chunks", [1, 19, 1025, 4096, 1 << 24])
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
@pytest.mark.parametrize("batch", [1, 129, 300, 4097, 1 << 22])
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


def _sha256(words):
    return hashlib.sha256(np.ascontiguousarray(words_to_numpy(words)).tobytes()).hexdigest()[:32]


@_path("main", ("mul_chunks", "mul_decrypt", "mul_count", "decrypt_parity", "chunk_matches",
                 "encrypt_bits_threefry", "encrypt_bits_counter"))
def test_main_path_at_full_size_draws_what_jax_draws(dev):
    """The JAX CLI demo's derivation at Context(1247, 16) on the card:
    ``keys = split(key(SEED), 4)``, the secret key from keys[0] and two
    4096-bit batches on the default engine (K14) under keys[1] and keys[2]
    are JAX's key and words (tests/torch_jax_draws.py), as are the port's
    rng draws; then the decrypts, one counter-engine batch (K4), the fused
    4096 x 4096 product on the canonical aligned route, ``*`` and ``+``."""
    assert draws.rng_vectors(draws.SEED) == draws.RNG_VECTORS
    keys = rng.split(rng.key(draws.SEED), 4)
    bits1, bits2 = draws.main_bits()
    op_metrics().reset()
    sk = SecretKey.generate(CTX, keys[0], dev)
    assert sk.indices.tolist() == draws.MAIN_KEY_INDICES
    c1 = Ciphertext(sk.encrypt_batch(bits1, keys[1]), CTX)
    c2 = Ciphertext(sk.encrypt_batch(bits2, keys[2]), CTX)
    c3 = Ciphertext(sk.encrypt_batch(bits1, draws.SEED + 1), CTX)     # the counter engine
    assert (_sha256(c1.wt), _sha256(c2.wt)) == draws.MAIN_WORDS_SHA256
    for c, bits in ((c1, bits1), (c2, bits2), (c3, bits1)):
        assert np.array_equal(sk.decrypt_batch(c.wt).cpu().numpy(), bits)
    assert int(sk.decrypt(c1)) == int(sk.decrypt(c2)) == 1
    prod, parity = sk.mul_and_decrypt(c1, c2)
    assert int(parity) == int(sk.decrypt(prod)) == 1
    assert torch.equal((c1 * c2).wt, prod.wt)
    assert torch.equal(prod.wt, core.mul_chunks(c1.wt, c2.wt))
    assert int(sk.decrypt(c1 + c2)) == 0 and int(sk.decrypt(c1 + c3)) == 0
    routes = {k: v["calls"] for k, v in op_metrics().snapshot().items()
              if k.startswith(("dispatch.mul", "mul_chunks.", "mul_decrypt."))}
    assert routes == {"dispatch.mul.cuda": 1, "dispatch.mul_dec.cuda": 1,
                      "mul_chunks.aligned": 1, "mul_decrypt.aligned": 1}, routes
    cpu_sk = SecretKey(CTX, sk.indices, "cpu")
    head = encrypt_kernels.encrypt_bits_threefry(
        keys[1], torch.from_numpy(bits1[:64]), *cpu_sk.encrypt_operands, total=draws.MAIN_T)
    assert torch.equal(c1.wt[:, :64].cpu(), head)


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


@_path("entry", ("encrypt_bits_threefry", "encrypt_bits_counter", "encrypt_bits_philox",
                  "philox_tile", "philox_streams", "fill_anchor", "mul_chunks", "mul_decrypt",
                  "mul_count", "mul_chunks_unaligned", "decrypt_parity", "decrypt_parity_batched",
                  "chunk_matches", "apply_benes"))
def test_entry_points_at_full_size(dev, tmp_path):
    """The entry points at Context(1247, 16), no device named anywhere (so
    each lands on the card): every CLI command in-process, a 2^22-bit
    Philox round trip and a fused product of two 4096-bit Philox batches, a
    checkpoint of a 4099 x 37 chain product with its key and a permutation
    through both formats, and the encrypt statistics at Context(4095, 32)
    over 2^20 columns."""
    from csgn_tpu_torch import RunConfig, cli
    from csgn_tpu_torch import io as cio
    from csgn_tpu_torch.pipeline import mul_chain
    from csgn_tpu_torch.tools import enc_stats

    seed = draws.SEED
    small = ["--n", str(CTX.n), "--d", str(CTX.d), "--seed", str(seed)]
    configs = {}
    for name, batch in (("selftest", 1 << 22), ("timings", 4096)):
        configs[name] = tmp_path / f"{name}.json"
        configs[name].write_text(RunConfig(CTX.n, CTX.d, seed, batch).to_json())
    for argv in (["demo", *small], ["selftest", "--config", str(configs["selftest"])],
                 ["timings", "--config", str(configs["timings"])], ["info", *small],
                 ["flagship", *small]):
        assert cli.main(argv) == 0, argv

    draw = np.random.default_rng(seed)
    sk = SecretKey(CTX, draw.choice(CTX.n, CTX.d, replace=False))
    assert sk.device.type == "cuda"
    bits = draw.integers(0, 2, 1 << 22).astype(np.int32)
    words = sk.encrypt_batch(bits, seed + 600, engine="philox")
    assert np.array_equal(sk.decrypt_batch(words).cpu().numpy(), bits)
    del words
    c1, c2 = (Ciphertext(sk.encrypt_batch(b, seed + 610 + i, engine="philox"), CTX)
              for i, b in enumerate(draws.main_bits()))
    prod, parity = sk.mul_and_decrypt(c1, c2)
    assert int(parity) == int(core.chunk_matches(prod.wt, sk.mask_words).sum() & 1) == 1
    del prod

    chain = mul_chain([Ciphertext(sk.encrypt_batch(np.arange(t) % 3 == 0, seed + 620 + t), CTX)
                       for t in (4099, 37)])
    perm = Permutation.random(CTX, rng.key(seed))
    want = (int(sk.decrypt(chain)),
            int(sk.apply_permutation(perm).decrypt(chain.apply_permutation(perm))))
    assert want == (1, 1)                       # 1367 and 13 ones: odd parities
    objects = {"chain": chain, "sk": sk, "perm": perm}
    cio.save_state(tmp_path / "state.npz", objects)
    cio.save_state_sharded(tmp_path / "sharded", objects)
    for st in (cio.load_state(tmp_path / "state.npz"),
               cio.load_state_sharded(tmp_path / "sharded")):
        assert st["chain"].wt.is_cuda and st["sk"].device.type == "cuda"
        assert torch.equal(st["chain"].wt, chain.wt)
        assert np.array_equal(st["sk"].indices, sk.indices) and st["perm"] == perm
        assert (int(st["sk"].decrypt(st["chain"])), int(st["sk"].apply_permutation(
            st["perm"]).decrypt(st["chain"].apply_permutation(st["perm"])))) == want

    stats = enc_stats.run(Context(4095, 32), 1 << 20, 424242)
    assert stats["ok"], stats["failed"]


@_path("rotation", ("mul_chunks", "apply_benes", "apply_benes_batch", "apply_benes_decrypt",
                     "decrypt_parity", "mul_chunks_batched", "mul_decrypt_batched",
                     "mul_count_batched", "decrypt_parity_batched", "encrypt_bits_counter"))
def test_rotation_path_at_full_size(dev):
    """Key rotation at Context(1247, 16) through the public API: a 4096 x
    4096 product (2^24 chunks) permuted, decrypted under the permuted key,
    through `permute_and_decrypt` and through K12's ops-level function, and
    permuted back; a fleet of 64 128-chunk ciphertexts multiplied into
    [64, 40, 16384], decrypted, re-keyed under 64 permutations, one each,
    and under one shared permutation, and decrypted under the rotated keys."""
    sk = _key(CTX, 21, dev)
    c1, c2 = (Ciphertext(sk.encrypt_batch(b, 30 + i), CTX) for i, b in enumerate(draws.main_bits()))
    prod = c1 * c2
    p = Permutation.random(CTX, rng.key(21))
    psk = sk.apply_permutation(p)
    rot = prod.apply_permutation(p)
    assert int(psk.decrypt(rot)) == 1
    assert torch.equal(rot.wt[:, :4096], core.permute_chunks(prod.wt[:, :4096],
                                                             torch.tensor(p.perm), CTX.n))
    staged, parity = sk.permute_and_decrypt(prod, p)
    assert torch.equal(staged.wt, rot.wt) and int(parity) == 1
    del staged
    fused, parity = benes_kernels.apply_benes_decrypt(prod.wt, p.benes_plan(), psk.mask_words)
    assert torch.equal(fused, rot.wt) and int(parity) == 1
    del fused
    assert torch.equal(rot.apply_permutation(p.inverse()).wt, prod.wt)
    del rot, prod

    bits = np.random.default_rng(21).integers(0, 2, (64, 128)).astype(np.int32)
    bits[0, 0] ^= int(bits[0].sum() % 2 == 0)          # element 0 decrypts to 1,
    bits[1, 0] ^= int(bits[1].sum() % 2 == 1)          # element 1 to 0
    want = bits.sum(axis=1) % 2
    batch = CiphertextBatch.stack([Ciphertext(sk.encrypt_batch(b, 100 + i), CTX)
                                   for i, b in enumerate(bits)])
    grown = batch * batch
    assert tuple(grown.wt.shape) == (64, CTX.words32, 128 * 128)
    assert np.array_equal(sk.decrypt_batch(grown).cpu().numpy(), want)
    fused_prod, fused_bits = sk.mul_and_decrypt_batch(batch, batch)
    assert torch.equal(fused_prod.wt, grown.wt)
    assert np.array_equal(fused_bits.cpu().numpy(), want)
    perms = [Permutation.random(CTX, rng.key(200 + i)) for i in range(64)]
    rotated = grown.apply_permutations(perms)
    assert [int(sk.apply_permutation(q).decrypt(rotated[i]))
            for i, q in enumerate(perms)] == want.tolist()
    for i in (0, 63):
        assert torch.equal(rotated.wt[i], core.permute_chunks(grown.wt[i],
                                                              torch.tensor(perms[i].perm), CTX.n))
    assert np.array_equal(psk.decrypt_batch(grown.apply_permutation(p)).cpu().numpy(), want)



def _fleet_store(dev, b=64, c=1 << 16):
    """The ``rotate-fleet`` cell's fleet at Context(1247, 16): b stored
    ciphertexts' words of c fresh chunks, their key's positions, and b
    readers' permutations with their plans built."""
    positions = key_positions(25, CTX.n, CTX.d)
    gen = torch.Generator(device=dev).manual_seed(25)
    bits = torch.randint(0, 2, (b, c), device=dev, generator=gen)
    store = fresh_chunks(bits, positions, CTX.n, gen).transpose(1, 2).contiguous()
    perms = [host_rng(25, f"reader-{r}").permutation(CTX.n) for r in range(b)]
    pis = [Permutation(p) for p in perms]
    for pi in pis:
        pi.benes_plan()
    return positions, store, perms, pis


@_path("fleet", ("apply_benes_batch",))
def test_fleet_route_at_full_size(dev):
    """A key-rotation fleet at Context(1247, 16) through the public API, at
    the ``rotate-fleet`` cell's size: 64 stored ciphertexts of 65,536 fresh
    chunks, each re-keyed to its own reader by ``submit_permute`` on an
    executor that holds no key, and one ``flush()``: one K9 call on the
    register path, reading the requests and their plans where they are
    stored (its table form), each plan uploaded once and nothing when the
    fleet comes again, and every request's words and its bit under its
    reader's key the reference's (portbench/reference/fleet.py), one
    request at a time."""
    positions, store, perms, pis = _fleet_store(dev)
    plans = [pi.benes_plan() for pi in pis]
    ex = BatchExecutor(None)
    before = op_metrics().snapshot()
    futs = [ex.submit_permute(Ciphertext(store[i], CTX), pi) for i, pi in enumerate(pis)]
    ex.flush()
    out = [f.result() for f in futs]
    torch.cuda.synchronize()
    after = op_metrics().snapshot()

    def grew(name, field="calls"):
        return after.get(name, {}).get(field, 0) - before.get(name, {}).get(field, 0)

    assert grew("apply_benes_batch.register") == 1 and grew("perm.plan_builds") == 0
    assert grew("apply_benes_batch.table") == grew("executor.perm.inplace") == 1
    sched = 2 * 4 * len(plans[0].deltas)
    upload = sum(p.masks.nbytes + sched for p in plans) + sched
    assert (grew("perm.plan_upload_bytes"), grew("perm.plan_upload_bytes", "bytes_moved")) \
        == (65, upload) == (65, 64 * (5376 + 168) + 168)
    again = [ex.submit_permute(Ciphertext(store[i], CTX), pi) for i, pi in enumerate(pis)]
    ex.flush()
    assert all(torch.equal(f.result().wt, o.wt) for f, o in zip(again, out))
    after = op_metrics().snapshot()
    assert grew("perm.plan_upload_bytes", "bytes_moved") == upload
    parities = set()
    for i in range(len(pis)):
        assert out[i].is_canonical and out[i].wt.data_ptr() != store[i].data_ptr()
        assert fleet.check(out[i].wt, store[i], perms[i], positions, CTX.n) == (0, 0), i
        parities.add(fleet.parity(store[i], positions, CTX.n))
    assert parities == {0, 1}


@pytest.mark.parametrize("route,stacks", [("inplace", 1), ("stacked", 2)])
def test_fleet_flush_allocates_no_stack(dev, monkeypatch, route, stacks):
    """The peak memory of a ``rotate-fleet`` flush over what it holds
    before: the output and the plans' copies on the in-place route (1x the
    fleet's words), a stack of the requests besides on the stacked route
    (2x).  Not a path test: `chip_smoke.py` runs each wrapper's plain
    version beside it, which allocates too."""
    if route == "stacked":
        monkeypatch.setattr(serve, "_reads_in_place", lambda cts: False)
    _, store, _, pis = _fleet_store(dev)
    ex = BatchExecutor(None)
    futs = [ex.submit_permute(Ciphertext(store[i], CTX), pi) for i, pi in enumerate(pis)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ex.flush()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    assert all(f.done for f in futs)
    assert stacks * store.nbytes <= peak <= stacks * store.nbytes + (8 << 20), (peak, store.nbytes)


def _uploads():
    return op_metrics().snapshot().get("key.upload.async", {}).get("calls", 0)


def test_rotated_key_and_its_decrypt_queue_behind_k1(dev):
    """With 4096² K1s in flight, the rotated key's build and the enqueue of
    K8 and K3 (`dispatch.permute_decrypt`) synchronise nothing with the
    card (torch's sync debug mode raises on any wait) and return before the
    stream drains; the key's words came up by one non-blocking copy
    (``key.upload.async``) and equal a CPU key's; the rotation and bit are
    right."""
    sk = _key(CTX, 22, dev)
    a, b = _words(CTX, 4096, 1, dev), _words(CTX, 4096, 2, dev)
    p = Permutation(np.random.default_rng(22).permutation(CTX.n))
    plan = p.benes_plan()
    dispatch.permute_decrypt(a, plan, sk.mask_words)  # the plan on the card, the library loaded
    torch.cuda.synchronize()
    uploads = _uploads()
    for _ in range(4):
        prod = kernels.mul_chunks(a, b)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        psk = sk.apply_permutation(p)
        out, parity = dispatch.permute_decrypt(prod, plan, psk.mask_words)
        drained = torch.cuda.current_stream().query()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert not drained
    assert _uploads() == uploads + 1
    cpu = SecretKey(CTX, sk.indices, "cpu").apply_permutation(p)
    np.testing.assert_array_equal(psk.indices, cpu.indices)
    for got, want in zip(psk.encrypt_operands, cpu.encrypt_operands):
        assert got.device == prod.device and torch.equal(got.cpu(), want)
    assert torch.equal(out, benes_kernels.apply_benes(prod, plan))
    assert int(parity) == int(kernels.decrypt_parity(prod, sk.mask_words))


def test_key_uploads_behind_long_kernels_keep_their_words(dev):
    """256 keys built back to back, each upload queued behind a K1 of 4096 ×
    1024 chunks: every key reads back its own words, so no pinned block was
    reused before its copy landed."""
    a, b = _words(CTX, 4096, 3, dev), _words(CTX, 1024, 4, dev)
    gen = np.random.default_rng(256)
    uploads = _uploads()
    keys = []
    for _ in range(256):
        kernels.mul_chunks(a, b)
        keys.append(SecretKey(CTX, gen.choice(CTX.n, CTX.d, replace=False), dev))
    assert _uploads() == uploads + 256
    for k in keys:
        cpu = SecretKey(CTX, k.indices, "cpu")
        for got, want in zip(k.encrypt_operands, cpu.encrypt_operands):
            assert torch.equal(got.cpu(), want)


def _perm_words(n, lead, chunks, seed, dev):
    ctx = Context(n, min(16, n // 2))
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(*lead, ctx.words32, chunks), dtype=np.uint32)
    return ctx, rng, words_from_numpy(w & ctx.valid_mask[:, None], dev)


# Every network width of the register path (WP = n_pad / 32 = 1, 2, 4, ...,
# 64) and WP = 128 of the lane-group path.
BENES_WP_NS = [17, 20, 31, 33, 50, 100, 200, 400, 700, 1247, 2048, 2049, 4095]


@pytest.mark.parametrize("n", BENES_WP_NS)
@pytest.mark.parametrize("chunks", [1, 127, 129, 255, 256, 257, 3 * 256 + 37, 1025, 1 << 20])
def test_benes_k8_k12_match_plain(dev, n, chunks):
    """Ragged chunk counts, those around the register path's 256-column
    block and 2^20, and n < 32 (W = 2 rows against a 1-row network), at
    every network width."""
    ctx, rng, x = _perm_words(n, (), chunks, n * 10 + chunks, dev)
    p = Permutation(rng.permutation(n))
    plan = p.benes_plan()
    want = benes_kernels.apply_benes_plain(x, plan)
    got = benes_kernels.apply_benes(x, plan)
    assert torch.equal(got, want)
    # The bit-level gather oracle unpacks every bit to int64: 4096 columns.
    assert torch.equal(got[:, :4096], core.permute_chunks(x[:, :4096], torch.tensor(p.perm), n))
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
@pytest.mark.parametrize("k,chunks", [(1, 129), (3, 1), (3, 1025), (64, 33), (64, 1 << 14)])
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
    ctx, rng, x = _perm_words(1247, (), 1 << 20, 9, dev)
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


N4096 = Context(4096, 32)  # csgn4096-rekey's context: W = 128, a 128-word network


@pytest.mark.parametrize("ctx,chunks", [(CTX, 1 << 22), (CTX, (1 << 22) + 37), (CTX, 1 << 24),
                                        (CTX, (1 << 24) + 37), (N4096, 1 << 24),
                                        (N4096, (1 << 24) + 37)],
                         ids=lambda v: f"{v.n}x{v.d}" if isinstance(v, Context) else str(v))
@_path("rotation", lambda ctx, **_: ("apply_benes", *(("benes_lanes",) if ctx is N4096 else ())))
def test_benes_k8_at_millions_of_chunks_matches_the_reference(dev, ctx, chunks):
    """K8 through `Ciphertext.apply_permutation`, on its register path at
    n = 1247 and its lane-group path at n = 4096 (W = 128: 2^31 words at
    2^24 chunks, past int32's element count; the ring form at 2^24, the
    tile form at 2^24 + 37), up to a 4096 x 4096 product's 2^24 chunks and
    with a partial last block, against the benchmark's plain gather
    (portbench/reference/rekey.py), compared in blocks of 2^20 chunks."""
    gen = torch.Generator(device=dev).manual_seed(chunks)
    x = torch.randint(-2**31, 2**31, (ctx.words32, chunks), dtype=torch.int32, device=dev,
                      generator=gen)
    x &= words_from_numpy(ctx.valid_mask, dev)[:, None]
    perm = np.random.default_rng(chunks).permutation(ctx.n)
    p = Permutation(perm)
    path = "lanes" if ctx is N4096 else "register"
    assert benes_kernels.benes_path(p.benes_plan().words_pad) == path
    launches = benes_kernels.LAUNCHES["apply_benes"]
    op_metrics().reset()
    got = Ciphertext(x, ctx).apply_permutation(p).wt
    assert benes_kernels.LAUNCHES["apply_benes"] > launches
    rings = op_metrics().snapshot().get("apply_benes.lanes.ring", {"calls": 0})["calls"]
    assert rings == (1 if path == "lanes" and chunks % 4 == 0 else 0)
    step = 1 << 20
    for c0 in range(0, chunks, step):
        assert torch.equal(got[:, c0:c0 + step], rekey.rotate(x[:, c0:c0 + step], perm)), c0


@_path("rotation", ("mul_chunks", "apply_benes", "benes_lanes", "decrypt_parity"))
def test_rekey_op_at_n4096_matches_the_reference(dev):
    """The ``rekey-4096-n4096`` cell's op once at its size: a 4096 x 4096
    product of fresh chunks at Context(4096, 32) (2^24 chunks of W = 128)
    re-keyed by `SecretKey.permute_and_decrypt` on the lane-group path's
    ring form, then
    K3 under the rotated key, against the benchmark's reference: every
    rotated word and the bit Dec_k(a * b) (`rekey.check_rotated`)."""
    seed = 2**33 + 23
    positions = key_positions(seed, N4096.n, N4096.d)
    gen = torch.Generator(device=dev).manual_seed(seed)
    operands = []
    for _ in range(2):
        bits = torch.randint(0, 2, (4096,), device=dev, generator=gen)
        bits[0] ^= 1 - int(bits.sum()) % 2             # odd: the product decrypts to 1
        operands.append(fresh_chunks(bits, positions, N4096.n, gen).T.contiguous())
    a, b = operands
    perm = np.random.default_rng(seed).permutation(N4096.n)
    p = Permutation(perm)
    sk = SecretKey(N4096, positions, dev)
    p.benes_plan()
    op_metrics().reset()
    rot, bit = sk.permute_and_decrypt(Ciphertext(a, N4096) * Ciphertext(b, N4096), p)
    routes = {k: v["calls"] for k, v in op_metrics().snapshot().items()
              if k.startswith(("apply_benes.", "mul_chunks."))}
    assert routes == {"apply_benes.lanes": 1, "apply_benes.lanes.ring": 1,
                      "mul_chunks.aligned": 1}, routes
    assert rot.is_canonical and tuple(rot.wt.shape) == (N4096.words32, 1 << 24)
    mask = torch.from_numpy(csgn.mask_words(positions, N4096.n)).to(dev)
    assert rekey.check_rotated(rot.wt, a, b, perm, mask) == (0, 1)
    assert int(bit) == 1
    np.testing.assert_array_equal(sk.apply_permutation(p).indices,
                                  rekey.rotated_positions(positions, perm))


@pytest.mark.parametrize("n,k,chunks", [(1247, 3, 60001), (1247, 64, 1000), (1247, 700, 129),
                                        (100, 700, 33), (4095, 64, 1 << 14)])
def test_benes_k9_fleets_match_plain(dev, n, k, chunks):
    """K9 on fleets of 3 long elements, 64 of four blocks and 700 of one
    block, each element on one of five plans in a drawn order, against the
    plain batch; and 64 elements of 2^14 chunks on the lane-group path."""
    _, rng, x = _perm_words(n, (k,), chunks, k + chunks, dev)
    pool = [Permutation(rng.permutation(n)).benes_plan() for _ in range(5)]
    stacked = pb.stack_plans([pool[i] for i in rng.integers(0, 5, size=k)])
    got = benes_kernels.apply_benes_batch(x, stacked)
    assert torch.equal(got, benes_kernels.apply_benes_batch_plain(x, stacked))


@pytest.mark.parametrize("n,k,chunks", [*((n, 3, 129) for n in (20, 50, 100, 200, 400, 700,
                                                                  1247, 2048)),
                                        (1247, 64, 1 << 16), (1247, 3, (1 << 16) + 37),
                                        (20, 65537, 1)])
def test_benes_k9_table_form_matches_stacked_and_plain(dev, n, k, chunks):
    """K9's table form (`apply_benes_requests`) on k requests, each its own
    allocation, listed in a drawn order other than the allocations', each
    on one of five plans drawn per request: at every register-path width
    over a ragged 129-column grid, on the ``rotate-fleet`` cell's 64 x 2^16
    chunks, on 3 x (2^16 + 37) (a ragged last block) and on 65,537 requests
    (two grids), bit-exact to K9 on their stack and to the plain batch;
    counted as the table form."""
    words = list(_perm_words(n, (k,), chunks, 1000 * k + n, dev)[2].unbind(0))
    if k <= 64:
        words = [w.clone() for w in words]      # separate allocations
    rng = np.random.default_rng(n + k)
    reqs = [words[i] for i in rng.permutation(k)]
    pool = [Permutation(rng.permutation(n)).benes_plan() for _ in range(5)]
    plans = [pool[i] for i in rng.integers(0, 5, size=k)]
    before, table = dict(kernels.LAUNCHES), _count("apply_benes_batch.table")
    got = benes_kernels.apply_benes_requests(reqs, plans)
    assert kernels.LAUNCHES["apply_benes_batch"] == before["apply_benes_batch"] + -(-k // 65535)
    assert _count("apply_benes_batch.table") == table + 1
    x, stacked = torch.stack(reqs), pb.stack_plans(plans)
    assert torch.equal(got, benes_kernels.apply_benes_batch(x, stacked))
    assert torch.equal(got, benes_kernels.apply_benes_batch_plain(x, stacked))


def _count(name):
    return op_metrics().snapshot().get(name, {}).get("calls", 0)


def test_benes_k9_table_form_queues_behind_k1_and_refuses_wide_networks(dev):
    """With 4096² K1s in flight, the table form's launch (its plans already
    on the card) waits for nothing: the pointer table goes up without a
    stream wait (torch's sync debug mode raises on one).  A network past the
    register path (n = 4095) is refused, not rerouted."""
    a, b = _words(CTX, 4096, 3, dev), _words(CTX, 4096, 4, dev)
    reqs = [_perm_words(CTX.n, (), 4099, 50 + i, dev)[2] for i in range(5)]
    rng = np.random.default_rng(5)
    plans = [Permutation(rng.permutation(CTX.n)).benes_plan() for _ in range(5)]
    benes_kernels.apply_benes_requests(reqs, plans)    # the plans' copies, the pinned block
    torch.cuda.synchronize()
    for _ in range(4):
        kernels.mul_chunks(a, b)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = benes_kernels.apply_benes_requests(reqs, plans)
        drained = torch.cuda.current_stream().query()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert not drained
    stacked = pb.stack_plans(plans)
    assert torch.equal(got, benes_kernels.apply_benes_batch(torch.stack(reqs), stacked))
    _, rng4095, x = _perm_words(4095, (), 33, 4, dev)
    wide = [Permutation(rng4095.permutation(4095)).benes_plan()]
    with pytest.raises(ValueError, match="register path"):
        benes_kernels.apply_benes_requests([x], wide)


@pytest.mark.parametrize("batch,t1,t2", [(1, 3, 5), (4, 1, 1), (5, 13, 7), (3, 128, 130),
                                         (7, 13, 37), (64, 128, 128)])
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
                                   (3, 1030), (13, 16411), (4099, 1), (4099, 3), (4099, 37),
                                   (1021, 1021), (7, 16411), (1021, 16411), (4099 * 37, 111)])
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


T_STREAM = kernels.B_STREAM_BYTES // (4 * CTX.words32) + 1   # b just past the threshold


@pytest.mark.parametrize("batch,t1,t2", [(None, 3, T_STREAM), (2, 3, T_STREAM),
                                         (None, 16, 1 << 19)])
def test_tiled_mode_past_the_threshold(dev, batch, t1, t2):
    """b past `B_STREAM_BYTES` at W = 40: just past it, unaligned (t1*t2
    odd), 2-D and a batch of two; and 16 x 2^19 (b 84 MB), aligned."""
    sk = _key(CTX, 5, dev)
    a = _words(CTX, t1, 3, dev, sk.mask, forced=range(0, t1, 2))
    b = _words(CTX, t2, 4, dev, sk.mask, forced=range(0, t2, 1001))
    if batch:
        a = torch.stack([a, a.roll(1, dims=1)])
        b = torch.stack([b, b.roll(7, dims=1)])
    assert kernels.mul_mode(CTX.words32, t1, t2, True) == "tiled"
    assert bool((t1 * t2) % 4) == (t2 == T_STREAM)
    count = _check_mode(a, b, sk.mask_words, "tiled", batched=bool(batch))
    assert bool((count > 0).all())


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


# ---------------------------------------------------------------------------
# The fused count: the mode's product kernel, then the column-match pass
# ---------------------------------------------------------------------------

# (mode, t1, t2): one pass block an element (t1 + t2 <= 1024) and several.
COUNT_SHAPES = [("aligned", 4, 8), ("aligned", 2048, 4), ("unaligned", 3, 5),
                ("unaligned", 1021, 17), ("tiled", 7, 3), ("tiled", 7, 2049)]


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
    assert kernels.mul_mode(CTX.words32, t1, t2, True) == mode
    before = dict(kernels.LAUNCHES)
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
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


@pytest.mark.parametrize("mode,t1,t2", COUNT_SHAPES)
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


# Kernel families by a part of their mangled names, with their number of
# instantiations: the Beneš register path (WP = 1, 2, ..., 64, with and
# without the count, and K9's table form without it), lane-group path (the tile form's ten, the ring form's
# two) and wide path, the fill, the Philox
# tile (16- and 4-byte row stores), K14, the count pass, and the product
# kernels: aligned, and unaligned or b-streamed, each 2-D and batched.
KERNEL_FAMILIES = [("benes_register_kernel", 21), ("benes_lanes_kernel", 12),
                   ("benes_wide_kernel", 6), ("fill_kernel", 1), ("philox_tile_kernel", 2),
                   ("JaxThreefry", 1), ("match_count_kernel", 1), ("mul_kernelI", 2),
                   ("mul_ragged_kernelI", 4)]


@pytest.mark.parametrize("family,instances", KERNEL_FAMILIES)
def test_kernel_families_build_without_spills(dev, family, instances):
    """ptxas reports each family's instantiations, none of them spilling
    (with spills the ragged product ran up to 45 % slower on an H100)."""
    from csgn_tpu_torch.ops import _build

    rows = [r for r in _build.kernel_resources() if family in r["kernel"]]
    assert len(rows) == instances, [r["kernel"] for r in rows]
    for r in rows:
        assert r["spill_stores"] == r["spill_loads"] == 0, r


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


def _columns(words):
    """Fresh words [W, B] -> B one-chunk Ciphertexts."""
    cols = words.t().contiguous().unsqueeze(-1)
    return [Ciphertext(cols[k], CTX) for k in range(cols.shape[0])]


@_path("circuit", ("mul_chunks_unaligned", "mul_decrypt_unaligned", "mul_chunks_tiled",
                    "mul_decrypt_tiled", "mul_chunks_unaligned_batched",
                    "mul_decrypt_unaligned_batched", "mul_count", "mul_count_batched",
                    "decrypt_parity", "decrypt_parity_batched", "encrypt_bits_counter",
                    "encrypt_bits_threefry", "apply_benes_batch"))
def test_chain_circuit_and_serve_at_full_size(dev):
    """At Context(1247, 16) through the public API: a 4099 x 37 x 111 chain
    (`mul_chain`, then `mul_chain_decrypt`; 2.69 GB), a 1021 x 16411 and a
    16 x 2^19 product with `*` and `mul_and_decrypt` (canonical, parity =
    the plain count); a `BatchExecutor` fleet of 64 16-bit adders in one
    group launch, and 256 AES-128 blocks on the key-side route (block 0 is
    FIPS-197 C.1) flushed with groups of every other route."""
    from csgn_tpu_torch import BatchExecutor, models, pipeline
    from csgn_tpu_torch.circuit import lift
    from csgn_tpu_torch.models import netlist as nl

    sk = _key(CTX, 22, dev)
    m = sk.mask_words
    draw = np.random.default_rng(22)

    def oracle(words):
        return int(core.chunk_matches(words, m).sum() & 1)

    def odd(t):
        bits = draw.integers(0, 2, t).astype(np.int32)
        bits[0] ^= int(bits.sum() % 2 == 0)
        return bits

    cts = [Ciphertext(sk.encrypt_batch(odd(t), 300 + t), CTX) for t in (4099, 37, 111)]
    two = pipeline.mul_chain(cts[:2])
    three, parity = pipeline.mul_chain_decrypt(cts, sk)
    assert three.chunks == 4099 * 37 * 111
    assert torch.equal(three.wt, core.mul_chunks(two.wt, cts[2].wt))
    assert int(sk.decrypt(two)) == int(parity) == oracle(three.wt) == 1
    del two, three, cts
    for t1, t2 in ((1021, 16411), (16, 1 << 19)):
        c1, c2 = (Ciphertext(sk.encrypt_batch(odd(t), 310 + t), CTX) for t in (t1, t2))
        prod = c1 * c2
        prod2, parity = sk.mul_and_decrypt(c1, c2)
        assert torch.equal(prod.wt, prod2.wt) and prod.is_canonical and prod2.is_canonical
        assert int(parity) == oracle(prod.wt) == 1
        del prod, prod2

    ex = BatchExecutor(sk, rng=rng.key(22))
    adder = nl.adder(16)
    adder_in = draw.integers(0, 1 << 16, (64, 2))
    bits = (adder_in[:, :, None] >> np.arange(16)) & 1                  # [64, 2, 16]
    wires = _columns(sk.encrypt_batch(bits.reshape(-1), 400))
    futs = [ex.submit_netlist(adder, [wires[32 * r:32 * r + 16], wires[32 * r + 16:32 * r + 32]])
            for r in range(64)]
    groups = ex.stats["group_dispatches"]
    ex.flush()
    assert ex.stats["group_dispatches"] == groups + 1
    dec = [[ex.submit_decrypt(ct) for ct in f.result()[0]] for f in futs]
    ex.flush()
    got = np.array([[f.result() for f in row] for row in dec])
    assert np.array_equal(got, [nl.eval_plain(adder, [bits[r, 0], bits[r, 1]])[0]
                                for r in range(64)])
    assert np.array_equal((got << np.arange(17)).sum(axis=1), adder_in.sum(axis=1))
    del futs, dec

    aes = models.aes128()
    aes_bytes = draw.integers(0, 256, (256, 2, 16)).astype(np.uint8)
    aes_bytes[0] = [np.frombuffer(bytes.fromhex(h), np.uint8) for h in FIPS197_C1[:2]]
    aes_bits = np.array([nl.bits_from_bytes(bytes(k)) + nl.bits_from_bytes(bytes(x))
                         for k, x in aes_bytes])                         # [256, 256]
    wires = _columns(sk.encrypt_batch(aes_bits.reshape(-1), 500))
    aes_futs = [ex.submit_netlist_expr(aes, [wires[256 * r:256 * r + 128],
                                             wires[256 * r + 128:256 * r + 256]])
                for r in range(256)]
    enc_bits = draw.integers(0, 2, 100)
    enc_futs = [ex.submit_encrypt(int(b)) for b in enc_bits]
    xa = _columns(sk.encrypt_batch(draw.integers(0, 2, 32 * 3), 510))
    xb = _columns(sk.encrypt_batch(draw.integers(0, 2, 32 * 7), 511))
    ga = [functools.reduce(operator.add, xa[3 * i:3 * i + 3]) for i in range(32)]   # 3 chunks
    gb = [functools.reduce(operator.add, xb[7 * i:7 * i + 7]) for i in range(32)]   # 7 chunks
    md_futs = [ex.submit_mul_decrypt(x, y) for x, y in zip(ga, gb)]
    pct = Ciphertext(sk.encrypt_batch(draw.integers(0, 2, 129), 520), CTX)
    perms = [Permutation.random(CTX, rng.key(520 + i)) for i in range(8)]
    perm_futs = [ex.submit_permute(pct, q) for q in perms]
    leaf = CiphertextBatch.stack(ga[:8])
    circ = [lift(ga[i]) * gb[i] + ga[i + 1] for i in range(8)] + [lift(leaf) * leaf + ga[0]]
    circ_futs = [ex.submit_decrypt_circuit(e) for e in circ]
    ex.flush()

    aes_out = [f.result()[0] for f in aes_futs]
    assert nl.bytes_from_bits(aes_out[0]).hex() == FIPS197_C1[2]
    packed = [int.from_bytes(np.packbits(aes_bits[:, j], bitorder="little").tobytes(), "little")
              for j in range(256)]
    ref = nl.eval_plain_packed(aes, [packed[:128], packed[128:]], 256)[0]
    assert np.array_equal(aes_out, [[(v >> r) & 1 for v in ref] for r in range(256)])
    enc = [f.result() for f in enc_futs]
    assert np.array_equal(sk.decrypt_batch(CiphertextBatch.stack(enc)).cpu().numpy(), enc_bits)
    ex2 = BatchExecutor(sk, rng=rng.key(22))
    again = [ex2.submit_encrypt(int(b)) for b in enc_bits]
    assert all(torch.equal(x.wt, y.result().wt) for x, y in zip(enc, again))
    for x, y, f in zip(ga, gb, md_futs):
        prod, bit = f.result()
        assert torch.equal(prod.wt, (x * y).wt) and bit == int(sk.decrypt(x * y))
    for q, f in zip(perms, perm_futs):
        assert int(sk.apply_permutation(q).decrypt(f.result())) == int(sk.decrypt(pct))
    got = [f.result() for f in circ_futs]
    assert got[:8] == [int(sk.decrypt(ga[i] * gb[i] + ga[i + 1])) for i in range(8)]
    assert np.array_equal(got[8], sk.decrypt_batch(
        leaf * leaf + CiphertextBatch.stack([ga[0]] * 8)).cpu().numpy())


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


PHILOX_T = encrypt_kernels.PHILOX_TILE_COLS
PHILOX_WIDE = encrypt_kernels.PHILOX_TILE_MAX_WORDS + 4     # past the tile path: the column path
ENC_BIG = (1 << 22) - 3, 1 << 22        # 4-byte and 16-byte tile row stores at full size


@pytest.mark.parametrize("w", [3, 4, 7, 40, 128, PHILOX_WIDE])
@pytest.mark.parametrize("d", [4, 16, 32])
@pytest.mark.parametrize("batch", [1, 255, 257, 4099, *ENC_BIG])
def test_philox_k7_k13_match_plain(dev, w, d, batch):
    """Rows W and W + 1 straddle two Philox groups at W % 4 == 3; the tile
    and column paths up to 2^22 columns."""
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


# (W, or a Context for its key's operands; d; batch; col0): batches around
# the Philox tile's width at every W, full-size batches at W in {3, 32, 40,
# 128}, and Context(1247, 16)'s key over 2^22 columns.
THREEFRY_CASES = (
    [(w, d, b, c) for w in (3, 4, 7, 40, 128) for d in (4, 16, 32)
     for b in (1, PHILOX_T - 1, PHILOX_T, PHILOX_T + 1, 255, 257, 4099) for c in (0, 4099)]
    + [(w, d, b, c) for w in (3, 32, 40, 128) for d in (4, 16, 32) for b in ENC_BIG
       for c in (0, 4099)]
    + [(CTX, CTX.d, 1 << 22, 0)])


def _threefry_plain(key, bits, ops, col0, total):
    """K14's plain version, 2^20 columns a call (its int64 temporaries)."""
    step = 1 << 20
    return torch.cat([encrypt_kernels.encrypt_bits_threefry_plain(
        key, bits[i:i + step], *ops, col0=col0 + i, total=total)
        for i in range(0, bits.shape[0], step)], dim=1)


@pytest.mark.parametrize("w,d,batch,col0", THREEFRY_CASES)
def test_threefry_k14_matches_plain(dev, w, d, batch, col0):
    """K14 at columns [col0, col0 + batch) of a batch + col0-column encrypt:
    its plain version's words, the bits back, the padding bits zero."""
    if isinstance(w, Context):
        ops, w = _key(w, 1, dev).encrypt_operands, w.words32
    else:
        ops = _philox_operands(w, d, dev, w * 100 + d)
    bits = torch.from_numpy(np.random.default_rng(batch).integers(0, 2, batch)).to(dev)
    key = rng.key((w << 20) + batch)
    before = encrypt_kernels.LAUNCHES["encrypt_bits_threefry"]
    got = encrypt_kernels.encrypt_bits_threefry(key, bits, *ops, col0=col0, total=col0 + batch)
    assert encrypt_kernels.LAUNCHES["encrypt_bits_threefry"] == before + 1
    assert torch.equal(got, _threefry_plain(key, bits, ops, col0, col0 + batch))
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
@pytest.mark.parametrize("col0", [0, 5, 4099])
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
@pytest.mark.parametrize("batch", [PHILOX_T + 1, 4096, 1 << 20, 1 << 22])
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
                                     (64, 64, 128), (7, 9, 1), (1, 3, 1), (1021, 16411, 3),
                                     (1, 1, 7), (1021, 16411, 40), (4096, 4096, 40)])
def test_fill_anchor_k5_matches_plain(dev, t1, t2, w):
    """C % 4 != 0, W*C below one block, and W*C % 4 != 0 (the words after the
    last 16-byte store), up to the 4096 x 4096 product's 163,840 blocks of
    16 KB (2.68 GB), and the W*C % 4 tail words."""
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


@pytest.mark.parametrize("n,chunks", [(n, c) for n in LANE_NS for c in (1, 129, 1000, 1025)]
                         + [(8191, 1 << 20), (16383, 1 << 20), (20000, 1 << 14),
                            (40000, 1 << 14)])
def test_benes_lanes_k8_k9_k12_match_plain(dev, n, chunks):
    """K8, K12 and K9 routed to the lane-group path at every width it takes,
    over chunk counts that are not multiples of a warp's or a block's
    chunks, and over 2^20 chunks (2^14 past WP = 512)."""
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


def _ring_calls():
    """Calls of each Beneš wrapper that took the lane path's ring form."""
    return sum(v["calls"] for k, v in op_metrics().snapshot().items()
               if k.endswith(".lanes.ring"))


@pytest.mark.parametrize("n", [2049, 4095, 4096])
@pytest.mark.parametrize("chunks", [4, 1028, (1 << 20) + 4, 1025])
def test_benes_lanes_ring_form_k8_k9_k12_match_plain(dev, n, chunks):
    """K8, K12 (count and parity) and K9 (two plans) at WP = 128 (W = 65 of
    128 rows at n = 2049): the ring form where chunks % 4 == 0, the tile
    form at 1025; the ring counter counts exactly the ring form's calls."""
    ring = benes_kernels.lanes_form(128, chunks) == "ring"
    assert ring == (chunks % 4 == 0)
    op_metrics().reset()
    launched = _k8_k9_k12_on(None, n, chunks, dev)
    assert launched["benes_lanes"] == 4 and launched["benes_wide"] == 0
    assert _ring_calls() == (4 if ring else 0)


@pytest.mark.parametrize("chunks", [1028, (1 << 20) + 4])
def test_benes_lanes_ring_form_batch_of_three_plans(dev, chunks):
    """K9 on the ring form: three elements at n = 4096, each on its own
    plan, against the plain batch and each element's own K8."""
    n = 4096
    _, rng, xb = _perm_words(n, (3,), chunks, chunks + 3, dev)
    perms = [Permutation(rng.permutation(n)) for _ in range(3)]
    stacked = pb.stack_plans([q.benes_plan() for q in perms])
    op_metrics().reset()
    got = benes_kernels.apply_benes_batch(xb, stacked)
    assert _ring_calls() == 1
    assert torch.equal(got, benes_kernels.apply_benes_batch_plain(xb, stacked))
    for i in range(3):
        assert torch.equal(got[i], benes_kernels.apply_benes(xb[i].contiguous(),
                                                             perms[i].benes_plan()))


@pytest.mark.parametrize("n", [2049, 4096])
def test_benes_lanes_ring_form_zero_stage_plans(dev, n):
    """The identity (every stage off) and a transposition (most stages off)
    on the ring form (300 chunks) and, for the same words, the tile form
    (301)."""
    _, _, x = _perm_words(n, (), 301, 6, dev)
    swap = np.arange(n)
    swap[3], swap[n - 7] = swap[n - 7], swap[3]
    op_metrics().reset()
    for cols in (x[:, :300].contiguous(), x):
        for p in (Permutation.identity(n), Permutation(swap)):
            assert torch.equal(benes_kernels.apply_benes(cols, p.benes_plan()),
                               benes_kernels.apply_benes_plain(cols, p.benes_plan()))
        assert torch.equal(benes_kernels.apply_benes(cols, Permutation.identity(n).benes_plan()),
                           cols)
    assert _ring_calls() == 3


def test_benes_lanes_ring_form_takes_no_unaligned_words(dev):
    """A contiguous view 4 bytes off a 16-byte boundary keeps the tile form
    at WP = 128, and the register path never counts the ring."""
    _, rng, src = _perm_words(4096, (), 1028, 8, dev)
    plan = Permutation(rng.permutation(4096)).benes_plan()
    flat = torch.empty(src.numel() + 1, dtype=torch.int32, device=dev)
    view = flat[1:].view(src.shape)
    view.copy_(src)
    assert view.data_ptr() % 16 != 0
    op_metrics().reset()
    assert torch.equal(benes_kernels.apply_benes(view, plan),
                       benes_kernels.apply_benes_plain(src, plan))
    _, rng, small = _perm_words(1247, (), 1028, 8, dev)
    low = Permutation(rng.permutation(1247)).benes_plan()
    assert torch.equal(benes_kernels.apply_benes(small, low),
                       benes_kernels.apply_benes_plain(small, low))
    routes = {k: v["calls"] for k, v in op_metrics().snapshot().items()
              if k.startswith("apply_benes.")}
    assert routes == {"apply_benes.lanes": 1, "apply_benes.register": 1}, routes


@pytest.mark.parametrize("n", WIDE_NS)
@pytest.mark.parametrize("chunks", [4096, 1000, 1 << 14])
def test_benes_wide_path_k8_k9_k12_match_plain(dev, n, chunks):
    """K8, K12 (count) and K9 on the wide path, bit-equal to their plain
    versions, at 4,096 and 2^14 chunks and at 1,000 (not a multiple of the
    32-column tile): routed there at n = 70000, forced at the lane-group
    path's widths."""
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


@pytest.mark.parametrize("n,chunks", [(20, 129), (1247, 129), (4095, 129), (20000, 129),
                                      (20000, 1000), (20000, 1 << 14)])
def test_benes_wide_and_global_forms_match_plain(dev, n, chunks):
    """The wide path forced onto narrow networks (n < 32 included), and its
    global-scratch form (taken past 32,768 words) forced at n <= 20000."""
    ctx, rng, x = _perm_words(n, (), chunks, n + 3, dev)
    p = Permutation(rng.permutation(n))
    plan = p.benes_plan()
    key = _key(ctx, n, "cpu").apply_permutation(p).mask_words.to(dev)
    x[:, 0:chunks:4] |= core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
    want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key,
                                                                   return_count=True)
    _, _, xb = _perm_words(n, (3,), chunks, n + 4, dev)
    stacked = pb.stack_plans([Permutation(rng.permutation(n)).benes_plan() for _ in range(3)])
    for path in ("wide", "global"):
        assert torch.equal(_benes_on(path, "apply_benes", x, plan)[0], want_out)
        out, count = _benes_on(path, "apply_benes_decrypt", x, plan, key)
        assert torch.equal(out, want_out)
        assert int(count) == int(want_count) >= len(range(0, chunks, 4))
        assert torch.equal(_benes_on(path, "apply_benes_batch", xb, stacked)[0],
                           benes_kernels.apply_benes_batch_plain(xb, stacked))


@pytest.mark.parametrize("n,path", [(20000, "benes_lanes"), (70000, "benes_wide")])
@_path("sharded", lambda path, **_: (path, "apply_benes", "apply_benes_batch", "decrypt_parity",
                                    "encrypt_bits_counter"))
def test_benes_wide_path_through_the_api(dev, n, path):
    """Context(20000, 16) on the lane-group path and Context(70000, 16) on
    the wide path: a ciphertext permuted on the card, decrypted under the
    permuted key (1), and permuted back; a fleet re-keyed per element."""
    before = kernels.LAUNCHES[path]
    ctx = Context(n, 16)
    sk = _key(ctx, 5, dev)
    p, q, _ = _wide_perms(n)
    c = Ciphertext(sk.encrypt_batch([1, 0, 0, 1, 1], 9), ctx)
    rot = c.apply_permutation(p)
    assert int(sk.apply_permutation(p).decrypt(rot)) == 1
    _, parity = sk.permute_and_decrypt(c, p)
    assert int(parity) == 1
    assert torch.equal(rot.apply_permutation(p.inverse()).wt, c.wt)
    fleet = CiphertextBatch.stack([c, Ciphertext(sk.encrypt_batch([0, 1, 1, 1, 0], 10), ctx)])
    got = fleet.apply_permutations([p, q])
    assert [int(sk.apply_permutation(x).decrypt(got[i])) for i, x in enumerate((p, q))] == [1, 1]
    assert kernels.LAUNCHES[path] >= before + 4


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


@pytest.mark.parametrize("ta,tb,tc", [(1000, 37, 3), (4099, 37, 111)])
@_path("sharded", lambda ta, **_: (
    "mul_chunks", "mul_decrypt", "mul_count", "mul_chunks_batched", "mul_decrypt_batched",
    "mul_count_batched", "mul_chunks_unaligned_batched", "decrypt_parity",
    "decrypt_parity_batched", "encrypt_bits_counter", "encrypt_bits_threefry", "apply_benes",
    *(() if ta == 1000 else ("mul_chunks_unaligned", "mul_decrypt_unaligned"))))
def test_sharded_ops_at_world_size_one_equal_the_unsharded_calls(dev, nccl_world, tmp_path,
                                                                 ta, tb, tc):
    """Every sharded op on a mesh of one rank equals its unsharded call, at
    small shapes and at the circuit path's (the unaligned 4099 x 37, the
    chain 4099 x 37 x 111: 2.69 GB); and the 4096 x 4096 fused product of
    both sharded encrypts' key forms has the plain parity, 1."""
    from csgn_tpu_torch import io as cio
    from csgn_tpu_torch.parallel import dryrun
    from csgn_tpu_torch.pipeline import mul_chain_decrypt, mul_chain_sharded_decrypt

    par = nccl_world
    mesh = par.chunk_mesh()
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    sk = _key(CTX, 11, dev)
    m = sk.mask_words
    a = Ciphertext(sk.encrypt_batch(np.arange(ta) % 2 == 0, 1), CTX)
    b = Ciphertext(sk.encrypt_batch(np.arange(tb) % 3 == 0, 2), CTX)
    c = Ciphertext(sk.encrypt_batch(np.arange(tc) % 2 == 0, 3), CTX)
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
    assert torch.equal(par.sharded_permute_batch(pb2, p.benes_plan(), mesh2),
                       benes_kernels.apply_benes(pb2, p.benes_plan()))
    par_dir = tmp_path / "ckpt"
    cio.save_state_sharded(par_dir, {"prod": prod, "sk": sk}, mesh)
    back = cio.load_state_sharded(par_dir, mesh=mesh)
    assert torch.equal(back["prod"].wt, prod.wt) and back["prod"].wt.is_cuda
    assert dryrun.run(workdir=tmp_path)["parity"] == 1
    x, y = (torch.from_numpy(bits).to(dev) for bits in draws.main_bits())
    x = par.sharded_encrypt_bits(rng.key(5), x, *sk.encrypt_operands, CTX.n, CTX.d, mesh)
    y = par.sharded_encrypt_bits_invariant(rng.key(6), y, *sk.encrypt_operands, CTX.n, CTX.d,
                                           mesh)
    words, parity = par.sharded_mul_decrypt(x, y, m, mesh)
    assert int(parity) == int(core.chunk_matches(words, m).sum() & 1) == 1


# ---------------------------------------------------------------------------
# The user programs on the card
# ---------------------------------------------------------------------------


# Each example at Context(1247, 16): its arguments, what its result must
# hold (JAX's draws at the examples' default seeds among them), and the
# LAUNCHES keys its run on the card counts.
CIRCUIT_KEYS = ("encrypt_bits_threefry", "decrypt_parity_batched")
EXAMPLES = {
    "voting": (dict(voters=draws.MAIN_T), {"yes_votes": draws.VOTING_YES},
               ("encrypt_bits_threefry", "mul_chunks_unaligned", "decrypt_parity")),
    "deep_chain": ({}, {"depth": 16, "final_chunks": 16, "peak_chunks": 4096, "recrypts": 1,
                        "unbounded_chunks_would_be": 1 << 16, "decrypted": 1},
                   ("encrypt_bits_threefry", "mul_chunks", "mul_chunks_unaligned",
                    "decrypt_parity")),
    "key_rotation": (dict(fleet=64), {"fleet": 64},
                     ("encrypt_bits_threefry", "mul_chunks_batched", "apply_benes_batch",
                      "decrypt_parity", "decrypt_parity_batched")),
    "bristol_adder": ({}, {"sum": 123456789 + 987654321}, CIRCUIT_KEYS),
    "netlist_service": ({}, {"reserve": draws.AUCTION[0], "qualified": draws.AUCTION[1],
                             "encrypt_dispatches": 1}, CIRCUIT_KEYS),
    "encrypted_aes": ({}, {"ciphertext": FIPS197_C1[2]}, CIRCUIT_KEYS),
    "encrypted_hmac": ({}, {"tag": hmac.new(bytes(range(32)), b"attested by csgn_tpu",
                                            "sha256").hexdigest()}, CIRCUIT_KEYS),
    "sharded_pipeline": ({}, {"devices": 1, "batch": 64, "product_chunks": 64 * 64,
                              "parity": 0}, ("encrypt_bits_threefry", "mul_chunks",
                                             "decrypt_parity")),
}
TIMINGS = {"build_s", "eval_s", "decrypt_s"}    # host wall times, the keys two runs differ in


@pytest.mark.parametrize("name", list(EXAMPLES))
@_path("programs", lambda name, **_: EXAMPLES[name][2])
def test_examples_on_card_equal_cpu(dev, name):
    """Each example's main() on its default device, the card, returns its
    CPU run's dict on every key but the host timings (the CPU tests hold
    those dicts to the JAX examples'), and what the table above fixes."""
    import importlib

    example = importlib.import_module(f"csgn_tpu_torch.examples.{name}")
    kw, known, _ = EXAMPLES[name]
    got = example.main(**kw, n=CTX.n, d=CTX.d)
    want = example.main(**kw, n=CTX.n, d=CTX.d, device="cpu")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMINGS} == \
        {k: v for k, v in want.items() if k not in TIMINGS}
    assert {k: got[k] for k in known} == known


@_path("programs", ("mul_chunks", "mul_chunks_unaligned", "mul_decrypt", "mul_decrypt_unaligned",
                     "mul_decrypt_batched", "mul_count", "mul_count_batched", "decrypt_parity",
                     "chunk_matches", "encrypt_bits_threefry", "encrypt_bits_philox",
                     "philox_tile", "apply_benes", "apply_benes_batch"))
def test_validate_sweep_and_fault_demo_resume_on_card(dev, capsys):
    """The validate sweep at its full shapes, every kernel against its plain
    version on the card; the fault demo: two gloo ranks on the CPU, the
    last killed mid-step, the resume on the card bit-equal to the oracle;
    and the serving demo and the scaling report on their default device."""
    from csgn_tpu_torch.tools import scaling_bench, serve_demo, validate

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
    serve = serve_demo.main()           # raises if a batched result differs
    assert serve["device"] == torch.cuda.get_device_name() and len(serve["trials"]) == 3
    scaling = scaling_bench.run(nproc=1)
    assert [row["devices"] for row in scaling["rows"]] == [1] and scaling["rows"][0]["ms"] > 0


# ---------------------------------------------------------------------------
# The benchmark program on the card
# ---------------------------------------------------------------------------


@_path("bench", ("mul_chunks", "mul_decrypt", "mul_count", "mul_decrypt_batched",
                  "mul_count_batched", "decrypt_parity", "decrypt_parity_batched", "fill_anchor",
                  "encrypt_bits_philox", "philox_tile", "encrypt_bits_threefry", "apply_benes"))
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
@_path("order", lambda t1, t2, **_: (
    "mul_chunks_tiled", "mul_decrypt_tiled", "mul_count", "decrypt_parity", "apply_benes",
    "mul_chunks" if t1 * t2 % 4 == 0 else "mul_chunks_unaligned"))    # the swapped operands
def test_streamed_product_is_canonical_and_jmajor_canonicalizes(dev, t1, t2):
    """Where b streams, `*` and `mul_and_decrypt` stay on the canonical
    tiled route; the j-major product of the same operands
    (`mul_chunks_jmajor`, tagged) resolves to the canonical kernel's words,
    decrypts to the canonical parity, and keeps its tag right through
    permute (decrypted under the rotated key, and by `permute_and_decrypt`)
    and add."""
    from csgn_tpu_torch.ops import order

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
    q = jm.apply_permutation(p)
    assert q.logical is jm.logical
    assert torch.equal(q.canonical().wt, benes_kernels.apply_benes(want, p.benes_plan()))
    assert int(sk.apply_permutation(p).decrypt(q)) == int(want_parity)
    q2, parity = sk.permute_and_decrypt(jm, p)
    assert q2.logical is jm.logical and torch.equal(q2.wt, q.wt)
    assert int(parity) == int(want_parity)
    del q, q2
    s = jm + a
    assert torch.equal(s.canonical().wt, torch.cat([want, a.wt], dim=1))
    assert int(sk.decrypt(s)) == int(want_parity) ^ int(sk.decrypt(a))


def _force_jmajor(monkeypatch):
    """Every `*`, `mul_and_decrypt` and batched form takes the j-major route
    (the canonical kernel on the swapped operands), as
    tests/test_torch_order.py forces it."""
    def mul(a, b):
        return dispatch.mul_chunks_jmajor(a, b), True, 0, 0

    def mul_dec(a, b, m):
        out, parity = kernels.mul_decrypt(b, a, m)
        return out, True, 0, 0, parity

    for name, fn in (("mul_chunks_auto", mul), ("mul_decrypt_auto", mul_dec),
                     ("mul_chunks_batched", mul), ("mul_decrypt_batched_auto", mul_dec)):
        monkeypatch.setattr(dispatch, name, fn)


@_path("order", ("mul_chunks", "mul_decrypt", "mul_count", "mul_chunks_unaligned",
                 "mul_chunks_unaligned_batched", "mul_decrypt_unaligned_batched",
                 "mul_count_batched", "decrypt_parity", "decrypt_parity_batched",
                 "encrypt_bits_threefry", "encrypt_bits_counter"))
def test_tagged_products_through_the_api_serve_and_io(dev, monkeypatch, tmp_path):
    """Lazy chunk order on the card: 4096 x 4096 `*` and `mul_and_decrypt`
    forced onto the j-major route (K1 and K2 on swapped operands) resolve
    to K1's words, parity 1; small tagged products (mixed tags, one shared
    tag, none) through a serve flush give the canonical kernel's words and
    the staged parities; a tagged product serializes as its eager form,
    round-trips through io, and the sharded save refuses it."""
    from csgn_tpu_torch import BatchExecutor, set_eager_order
    from csgn_tpu_torch import io as cio

    sk = _key(CTX, 23, dev)
    m = sk.mask_words
    a, b = (Ciphertext(sk.encrypt_batch(bits, rng.key(40 + i)), CTX)
            for i, bits in enumerate(draws.main_bits()))
    x = [Ciphertext(sk.encrypt_batch(np.arange(t) % 2 == 0, 50 + t), CTX) for t in (37, 5, 11)]
    _force_jmajor(monkeypatch)
    jm = a * b
    jm2, parity = sk.mul_and_decrypt(a, b)
    lazy = x[0] * x[1]
    shared = CiphertextBatch.stack([x[0], x[0]]) * CiphertextBatch.stack([x[1], x[1]])
    prev = set_eager_order(True)
    try:
        eager = x[0] * x[1]
    finally:
        set_eager_order(prev)
    monkeypatch.undo()
    assert not jm.is_canonical and jm.chunks == 4096 * 4096
    assert torch.equal(jm.wt, jm2.wt) and torch.equal(jm.logical, jm2.logical)
    assert torch.equal(jm.canonical().wt, kernels.mul_chunks(a.wt, b.wt))
    assert int(parity) == int(sk.decrypt(jm)) == 1
    del jm, jm2

    ex = BatchExecutor(sk, rng=rng.key(23))
    reqs = [(lazy, x[2]), (lazy.canonical(), x[2]), (shared[0], x[1]), (shared[1], x[1]),
            (x[2], x[0])]
    futs = [(ex.submit_mul(u, v), ex.submit_mul_decrypt(u, v), ex.submit_decrypt(u), u, v)
            for u, v in reqs]
    ex.flush()
    for fm, fmd, fd, u, v in futs:
        want = kernels.mul_chunks(u.canonical().wt, v.canonical().wt)
        prod, bit = fmd.result()
        assert torch.equal(fm.result().canonical().wt, want)
        assert torch.equal(prod.canonical().wt, want)
        assert (bit, fd.result()) == (int(kernels.decrypt_parity(want, m)), int(sk.decrypt(u)))

    assert eager.is_canonical and not lazy.is_canonical and not shared.is_canonical
    assert np.array_equal(eager.to_u64(), lazy.to_u64())
    cio.save_ciphertext(tmp_path / "lazy.npz", lazy)
    back = cio.load_ciphertext(tmp_path / "lazy.npz")
    assert back.is_canonical and torch.equal(back.wt, lazy.canonical().wt)
    with pytest.raises(ValueError, match="canonical payload"):
        cio.save_state_sharded(tmp_path / "sharded", {"ct": lazy})


@pytest.mark.parametrize("n,chunks", [(1247, 1 << 18), (4095, 1 << 16)])
@_path("order", lambda n, **_: ("apply_benes", *(("benes_lanes",) if n > 2048 else ())))
def test_permute_chunks_mxu_equals_k8(dev, n, chunks):
    """The one-hot bf16 permutation (`ops.permute_mxu`) against K8."""
    from csgn_tpu_torch.ops import permute_mxu

    _, draw, x = _perm_words(n, (), chunks, n, dev)
    q = Permutation(draw.permutation(n))
    got = permute_mxu.permute_chunks_mxu(x, permute_mxu.onehot_matrix(q.perm, n, dev), n)
    assert torch.equal(got, benes_kernels.apply_benes(x, q.benes_plan()))
