"""The re-key path — a product, then `SecretKey.permute_and_decrypt` to a
reader's permuted key — against the benchmark's plain reference
(portbench/reference/rekey.py), bit for bit, at both of the benchmark's
re-key contexts: Context(1247, 16), whose network takes K8's register path,
and Context(4096, 32), W = 128, whose network takes the lane-group path
(the cases with ids 1247x16 and 4096x32); the reference against csgn_tpu's
permutation oracle; the rotated key against csgn_tpu's; the ``rekey-4096`` and
``rekey-4096-n4096`` cells through the harness on the CPU; the path's spans,
plan counter, key-upload counters and the Beneš wrappers' path counters;
and the counts and readers of the cells' per-layer metrics.  Operands are
fresh chunks of seeded random bits (`portbench.inputs.fresh_chunks`), with
an odd number of ones on each side so that the product decrypts to 1.
Tolerance: 0 everywhere."""

import collections
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
from csgn_tpu.ops import core as jcore
import csgn_tpu_torch as T
from csgn_tpu_torch.layout import words_to_numpy
from csgn_tpu_torch.ops import benes_kernels, dispatch
from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.utils import metrics as M
from portbench import harness, rekey_work, tracing
from portbench.inputs import fresh_chunks, host_rng, key_positions
from portbench.peaks import HBM_BYTES_PER_S
from portbench.reference import csgn, rekey

N, D = 1247, 16
# (n, d) of csgn1247-rekey and csgn4096-rekey, and the path of their networks
CONTEXTS = pytest.mark.parametrize("n,d", [(N, D), (4096, 32)], ids=["1247x16", "4096x32"])
PATHS = {1247: "register", 4096: "lanes"}
CELLS = pytest.mark.parametrize("cell", ["rekey-4096", "rekey-4096-n4096"])
SEED = 2**33 + 41
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def rec():
    """The global recorder, cleared and off before and after the test."""
    r = M.op_metrics()
    r.disable()
    r.reset()
    yield r
    r.disable()
    r.reset()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(t1, t2, seed, n=N, d=D):
    """The key's positions and two operands ``[W, t]`` of fresh chunks, each
    with an odd number of ones."""
    positions = key_positions(seed, n, d)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in (t1, t2):
        bits = torch.randint(0, 2, (t,), generator=gen)
        bits[0] ^= 1 - int(bits.sum()) % 2
        out.append(fresh_chunks(bits, positions, n, gen).T.contiguous())
    return positions, *out


def _perm(kind, seed, n=N):
    p = host_rng(seed, "test-perm").permutation(n)
    return {"identity": np.arange(n), "random": p, "inverse": np.argsort(p)}[kind]


def _rekey(positions, a, b, perm, n=N, d=D):
    ctx = T.Context(n, d)
    sk = T.SecretKey(ctx, positions, "cpu")
    prod = T.Ciphertext(a, ctx) * T.Ciphertext(b, ctx)
    rot, bit = sk.permute_and_decrypt(prod, T.Permutation(perm))
    return sk, prod, rot, int(bit)


@pytest.mark.parametrize("t1,t2", [(8, 8), (37, 11), (3, 200)])
@pytest.mark.parametrize("kind", ["identity", "random", "inverse"])
@CONTEXTS
def test_rekey_matches_the_reference(t1, t2, kind, n, d):
    positions, a, b = _operands(t1, t2, SEED + t1, n, d)
    assert a.shape[0] == csgn.words_per_chunk(n) == T.Context(n, d).words32
    perm = _perm(kind, SEED + t2, n)
    sk, _, rot, bit = _rekey(positions, a, b, perm, n, d)
    want = rekey.rotate(csgn.cross_and(a, b), perm)
    assert torch.equal(rot.wt, want)
    mask = torch.from_numpy(csgn.mask_words(positions, n))
    assert rekey.check_rotated(rot.wt, a, b, perm, mask) == (0, 1)
    assert bit == 1
    rotated = rekey.rotated_positions(positions, perm)
    np.testing.assert_array_equal(sk.apply_permutation(T.Permutation(perm)).indices, rotated)
    # the reader decrypts the rotated words under the rotated key alone
    assert csgn.match_count(want, torch.from_numpy(csgn.mask_words(rotated, n))) & 1 == 1


def test_rekey_of_a_lazily_ordered_product(monkeypatch):
    """A j-major product (the card's swapped route, forced here) is rotated
    in its own chunk order; canonical, it is the reference's."""
    monkeypatch.setattr(dispatch, "mul_chunks_auto",
                        lambda a, b: (dispatch.mul_chunks_jmajor(a, b), True, 0, 0))
    positions, a, b = _operands(37, 11, SEED)
    perm = _perm("random", SEED)
    _, prod, rot, bit = _rekey(positions, a, b, perm)
    assert not prod.is_canonical and not rot.is_canonical
    assert torch.equal(rot.logical, prod.logical)
    assert torch.equal(rot.canonical().wt, rekey.rotate(csgn.cross_and(a, b), perm))
    assert bit == 1


def test_reference_rotation_by_hand():
    """n = 40 (W = 2): out bit i = in bit perm[i], MSB-first, bits past n 0;
    blocks of `ROTATE_CHUNKS` join seamlessly."""
    perm = np.arange(40)
    perm[[0, 33]] = [33, 0]  # swap bits 0 and 33
    # chunk 0 holds bit 0; chunk 1 bits 31 and 33
    x = torch.tensor([[0x80000000 - 2**32, 0x00000001], [0, 0x40000000]], dtype=torch.int32)
    got = rekey.rotate(x, perm).numpy().view(np.uint32)
    assert got.tolist() == [[0x00000000, 0x80000001], [0x40000000, 0x00000000]]
    assert rekey.rotated_positions([33, 5], perm).tolist() == [0, 5]
    wide = torch.randint(-2**31, 2**31, (2, rekey.ROTATE_CHUNKS + 3), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    wide &= torch.from_numpy(csgn.valid_words(40))[:, None]
    tail = rekey.rotate(wide, perm)[:, -5:]
    assert torch.equal(tail, rekey.rotate(wide[:, -5:], perm))


@CONTEXTS
def test_reference_rotation_matches_the_jax_oracle(n, d):
    """On the JAX package's key and permutation: the reference's rotation is
    `csgn_tpu.ops.core.permute_chunks`, its rotated key the JAX key's
    `apply_permutation`, and the JAX decrypt under it reads the same bit;
    the port's `permute_and_decrypt`, on the plan of its context's path,
    gives the same words and bit."""
    jctx = J.Context(n, d)
    key = jax.random.key(11)
    jsk = J.SecretKey.generate(jctx, jax.random.fold_in(key, 0))
    jp = J.Permutation.random(n, jax.random.fold_in(key, 1))
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (jctx.words32, 300), dtype=np.uint32) & jctx.valid_mask[:, None]
    words[:, ::7] |= jsk.mask[:, None]
    perm = np.asarray(jp.perm)
    got = rekey.rotate(torch.from_numpy(words.view(np.int32)), perm)
    want = jcore.permute_chunks(jnp.asarray(words), jnp.asarray(perm), n)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    rotated = rekey.rotated_positions(np.asarray(jsk.indices), perm)
    jpsk = jsk.apply_permutation(jp)
    np.testing.assert_array_equal(np.sort(np.asarray(jpsk.indices)), rotated)
    mask = torch.from_numpy(csgn.mask_words(rotated, n))
    jbit = int(jpsk.decrypt(J.Ciphertext(want, jctx)))
    assert csgn.match_count(got, mask) & 1 == jbit == len(range(0, 300, 7)) & 1
    p = T.Permutation(perm)
    assert benes_kernels.benes_path(p.benes_plan().words_pad) == PATHS[n]
    ctx = T.Context(n, d)
    sk = T.SecretKey(ctx, np.asarray(jsk.indices), "cpu")
    rot, bit = sk.permute_and_decrypt(T.Ciphertext(torch.from_numpy(words.view(np.int32)), ctx), p)
    np.testing.assert_array_equal(words_to_numpy(rot.wt), np.asarray(want))
    assert int(bit) == jbit


SMALL = {"shapes": [[37, 11]], "sets": 3, "readers": 2}


def _cell(cell, **kw):
    out, lines = harness.run_cell(cell, SEED, 0.3, kw.pop("trace", False), device="cpu",
                                  traffic=SMALL, **kw)
    assert len(lines) == len(out["checks"])
    return out


@CELLS
def test_cell_is_correct_on_the_program(rec, cell):
    """The cell on the CPU at small traffic; its registered metrics are the
    re-key cells', with the lane-group share at Context(4096, 32) alone."""
    bench = harness.manifest()
    lanes = {"kernel.benes_lanes_roofline"} if cell == "rekey-4096-n4096" else set()
    assert {m["name"] for m in harness.cell_metrics(bench, cell, True)} == {
        "idle.bulk", "kernel.rekey_roofline", "key.rekey_host_us", *lanes}
    assert {m["name"] for m in harness.cell_metrics(bench, cell, False)} == {
        "chunk_ops_per_s", "setup_s"}
    n = harness.cell_files(cell)["config"]["n"]
    assert benes_kernels.benes_path(T.Permutation.identity(n).benes_plan().words_pad) == PATHS[n]
    out = _cell(cell, trace=True)
    assert out["correct"] and out["attempted"] > 0, out
    assert all(c["value"] == 0 for c in out["checks"].values())
    # no device trace on the CPU: the rooflines read nothing, the spans do
    assert set(out["metrics"]) == {"key.rekey_host_us"}
    assert out["metrics"]["key.rekey_host_us"]["value"] > 0
    assert not rec.enabled


@CELLS
def test_cell_control_rotates_wrong_and_decrypts_right(rec, cell):
    checks = {k: v["value"] for k, v in _cell(cell, control=True)["checks"].items()}
    assert checks["rotated_words_wrong"] > 0
    assert checks["bits_wrong"] == checks["pairs_unchecked"] == 0


def _flip_bit(mp):
    orig = dispatch.permute_decrypt
    mp.setattr(dispatch, "permute_decrypt",
               lambda w, plan, mask: (lambda o, p: (o, p ^ 1))(*orig(w, plan, mask)))


def _flip_word(mp):
    orig = dispatch.permute_decrypt

    def broken(w, plan, mask):
        out, parity = orig(w, plan, mask)
        out = out.clone()
        out[0, -1] ^= 1 << 3
        return out, parity
    mp.setattr(dispatch, "permute_decrypt", broken)


@pytest.mark.parametrize("fault,key", [(_flip_bit, "bits_wrong"),
                                       (_flip_word, "rotated_words_wrong")])
@CELLS
def test_cell_catches_a_fault_in_the_timed_path(rec, monkeypatch, fault, key, cell):
    fault(monkeypatch)
    out = _cell(cell)
    assert not out["correct"] and out["checks"][key]["value"] > 0


def test_spans_only_while_recording(rec):
    positions, a, b = _operands(8, 8, SEED)
    perm = _perm("random", SEED)
    _rekey(positions, a, b, perm)
    assert rec.spans() == []
    with rec.recording():
        _rekey(positions, a, b, perm)
    spans = rec.spans()
    names = [s.name for s in spans]
    for name in ("key.apply_permutation", "key.permute_and_decrypt", "key.readback", "perm.plan"):
        assert name in names, names
    op = names.index("key.permute_and_decrypt")
    assert spans[names.index("key.apply_permutation")].parent == -1
    assert names.index("key.apply_permutation") < op
    assert [s.name for s in spans if s.parent == op][-1] == "key.readback"
    assert spans[names.index("perm.plan")].parent == op  # the plan is built on first use
    assert all(s.end >= s.start for s in spans)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, SEED])
@CONTEXTS
def test_key_transform_matches_the_jax_package(seed, n, d):
    """`apply_permutation`'s rotated key — ascending indices, mask and the
    key's device words — is the JAX package's for seeded keys and π."""
    positions = key_positions(seed, n, d)
    perm = host_rng(seed, "test-perm").permutation(n)
    psk = T.SecretKey(T.Context(n, d), positions, "cpu").apply_permutation(T.Permutation(perm))
    jpsk = J.SecretKey(J.Context(n, d), positions).apply_permutation(J.Permutation(perm))
    np.testing.assert_array_equal(psk.indices, np.asarray(jpsk.indices))
    assert np.all(np.diff(psk.indices) > 0)
    np.testing.assert_array_equal(psk.mask, np.asarray(jpsk.mask))
    idx, mask, valid = psk.encrypt_operands
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jpsk.indices))
    np.testing.assert_array_equal(words_to_numpy(mask), np.asarray(jpsk.mask))
    np.testing.assert_array_equal(words_to_numpy(valid), J.Context(n, d).valid_mask)


def _builds(rec):
    snap = rec.snapshot()
    return tuple(snap.get(f"key.upload.{kind}", {}).get("calls", 0)
                 for kind in ("blocking", "async"))


@pytest.mark.parametrize("build,keys", [
    (lambda ctx, pos, p: T.SecretKey(ctx, pos, "cpu"), 1),
    (lambda ctx, pos, p: T.SecretKey.generate(ctx, T.rng.key(3), "cpu"), 1),
    (lambda ctx, pos, p: T.SecretKey(ctx, pos, "cpu").apply_permutation(p), 2),
    (lambda ctx, pos, p: T.SecretKey(ctx, pos, "cpu").permute_and_decrypt(
        T.Ciphertext(_operands(8, 8, SEED)[1], ctx), p), 2),
], ids=["init", "generate", "apply_permutation", "permute_and_decrypt"])
def test_a_cpu_key_counts_blocking_uploads(rec, build, keys):
    """One ``key.upload.blocking`` a key built on the CPU (the key, then
    its rotation), and no ``key.upload.async`` (the card's route)."""
    build(T.Context(N, D), key_positions(SEED, N, D), T.Permutation(_perm("random", SEED)))
    assert _builds(rec) == (keys, 0)


def test_plan_builds_count_cache_misses_only(rec):
    perm = _perm("random", SEED)

    def builds():
        return rec.snapshot().get("perm.plan_builds", {}).get("calls", 0)

    p = T.Permutation(perm)
    plan = p.benes_plan()
    assert p.benes_plan() is plan and builds() == 1
    with rec.recording():
        q = T.Permutation(perm)
        q.benes_plan()
        q.benes_plan()
    assert builds() == 2
    assert [s.name for s in rec.spans()] == ["perm.plan"]


@pytest.mark.parametrize("n", [20, 95, 1247, 4095])
def test_network_ops_count_is_the_programs(n):
    """The benchmark's count is its own code; it agrees with the count the
    bring-up table's bounds use."""
    for k in range(3):
        plan = T.Permutation(np.random.default_rng(n + k).permutation(n)).benes_plan()
        assert rekey_work.network_ops(plan) == benes_kernels.network_ops(plan) > 0
    assert rekey_work.network_ops(T.Permutation.identity(n).benes_plan()) == 0


def _run(device_s, bytes_needed, ops=None, kind=H100, device_ops=()):
    tracer = tracing.Tracer(False, torch.device("cpu"))
    if ops is not None:
        rekey_work.add_ops(tracer, ops)
    return types.SimpleNamespace(device_kind=kind, bytes_needed=bytes_needed, tracer=tracer,
                                 trace=types.SimpleNamespace(device_s=device_s,
                                                             device_ops=list(device_ops)))


def test_roofline_reader_takes_the_larger_bound():
    read = harness.load("metrics", "kernel.rekey_roofline").read
    w, t = 40, 4096
    op = rekey_work.op_bytes(w, t, t)
    assert op == 4 * w * (2 * t + t * t)
    ops = 2022 * t * t
    rate = rekey_work.INT32_OPS_PER_S[H100]
    assert rate == pytest.approx(16.727e12, rel=1e-4)
    # ops-bound: 33.9 G operations at 16.73 T op/s is 2.03 ms
    assert read(_run(4.8e-3, op, ops)) == pytest.approx(100 * (ops / rate) / 4.8e-3)
    assert ops / rate > op / HBM_BYTES_PER_S[H100]
    # without the plans' count, the bytes alone: a lower bound
    assert read(_run(4.8e-3, op)) == pytest.approx(100 * (op / HBM_BYTES_PER_S[H100]) / 4.8e-3)
    assert read(_run(4.8e-3, op, kind="cpu")) is None
    run = _run(4.8e-3, op, ops)
    run.trace = None
    assert read(run) is None


def test_host_us_reader_reads_only_the_new_spans(rec):
    read = harness.load("metrics", "key.rekey_host_us").read
    with rec.recording():
        with rec.span("key.permute_and_decrypt"):
            with rec.span("key.readback"):
                pass
    assert read(None) is None  # the parent's program: no key.apply_permutation span
    rec.reset()
    with rec.recording():
        for _ in range(2):
            with rec.span("key.apply_permutation"):
                pass
            with rec.span("key.permute_and_decrypt"):
                with rec.span("key.readback"):
                    pass
    spans = rec.spans()
    want = sum(s.seconds for s in spans if s.name != "key.readback") - sum(
        s.seconds for s in spans if s.name == "key.readback")
    assert read(None) == pytest.approx(1e6 * want / 2)


# Kernel names as the profiler gives them, cut to the trace's 96 characters.
LANES_K8 = ("void benes::(anonymous namespace)::benes_lanes_kernel<64, 2, 128, false, true>"
            "(unsigned int co")
REGISTER_K8 = "void benes::(anonymous namespace)::benes_register_kernel<64, false>(unsigned int"
K1 = "void (anonymous namespace)::mul_kernel<4, false>(unsigned int const*, unsigned int co"


def test_lanes_roofline_reader_reads_the_lane_kernel_alone():
    """K8l's share: the window's network operations over the int32 rate
    against the lane kernel's own device time; None where no lane kernel
    ran, where the op counted no operations or the card has no peak."""
    read = harness.load("metrics", "kernel.benes_lanes_roofline").read
    t = 4096
    ops = 6654 * t * t                                  # one op at n = 4096
    op = rekey_work.op_bytes(128, t, t)
    rate = rekey_work.INT32_OPS_PER_S[H100]
    trace = [[LANES_K8, 0.0120], [K1, 0.0027], ["void decrypt_kernel<false, 4, false>", 0.0006]]
    run = _run(0.0153, op, ops, device_ops=trace)
    assert read(run) == pytest.approx(100 * (ops / rate) / 0.0120)
    assert 100 * (ops / rate) / 0.0120 == pytest.approx(55.6, abs=0.1)   # 6.67 of 12.0 ms
    # the lane kernel's share is larger than the whole op's, whose time holds K1 and K3
    whole = harness.load("metrics", "kernel.rekey_roofline").read(run)
    assert read(run) > whole == pytest.approx(100 * (ops / rate) / 0.0153)
    # two entries of the lane kernel (two instantiations) add up
    two = _run(0.0153, op, ops, device_ops=[[LANES_K8, 0.006], [LANES_K8 + "x", 0.006], *trace[1:]])
    assert read(two) == pytest.approx(read(run))
    # the register path's kernel (rekey-4096), or a parent without the lane path: nothing
    assert read(_run(0.0043, op, ops, device_ops=[[REGISTER_K8, 0.003], [K1, 0.0009]])) is None
    assert read(_run(0.0153, op, None, device_ops=trace)) is None
    assert read(_run(0.0153, op, ops, kind="cpu", device_ops=trace)) is None
    run.trace = None
    assert read(run) is None


class _Lib:
    """The kernel library's Beneš entry, recording its path code."""

    def __init__(self):
        self.paths = []

    def csgn_benes(self, *args):
        self.paths.append(args[-2])
        return 0


@pytest.mark.parametrize("n,path", [(1247, None), (4096, None), (4096, "wide"),
                                    (4096, "global")])
def test_benes_wrappers_count_their_path(rec, monkeypatch, n, path):
    """``<wrapper>.<path>`` counts each launching call of K8, K9 and K12 by
    the path it took: "register" at n = 1247, "lanes" at 4096 (the routed
    paths), or the path forced.  The CUDA call is a stub, so this runs the
    wrapper's host side alone; the plain route counts no path."""
    lib = _Lib()
    monkeypatch.setattr(benes_kernels, "lib", lambda: lib)
    monkeypatch.setattr(benes_kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(benes_kernels, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    plan = T.Permutation(_perm("random", SEED, n)).benes_plan()
    want = path or PATHS[n]
    w = csgn.words_per_chunk(n)
    x = torch.zeros((w, 33), dtype=torch.int32)
    mask = torch.zeros(w, dtype=torch.int32)
    stacked = pb.stack_plans([plan, plan])
    benes_kernels._benes_cuda("apply_benes", x, plan, 0, path=path)
    benes_kernels._benes_cuda("apply_benes_decrypt", x, plan, 0, mask, path=path)
    benes_kernels._benes_cuda("apply_benes_batch", torch.stack([x, x]), stacked,
                              len(stacked.deltas) * stacked.words_pad, path=path)
    benes_kernels._benes_cuda("apply_benes", x[:, :0], plan, 0, path=path)  # nothing launched
    counted = {k: v["calls"] for k, v in rec.snapshot().items() if k.startswith("apply_benes")}
    assert counted == {f"{name}.{want}": 1 for name in
                       ("apply_benes", "apply_benes_decrypt", "apply_benes_batch")}
    assert lib.paths == [benes_kernels._PATH_CODES[want]] * 3
    rec.reset()
    benes_kernels.apply_benes(x, plan)                  # a CPU tensor: the plain version
    assert not any(k.startswith("apply_benes") for k in rec.snapshot())
