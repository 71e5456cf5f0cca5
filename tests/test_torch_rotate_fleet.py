"""The key-rotation fleet — B stored ciphertexts, each re-keyed with its own
reader's permutation by `BatchExecutor.submit_permute` on an executor that
holds no key, then one ``flush()`` — against the benchmark's plain reference
(portbench/reference/fleet.py) and the JAX executor's ``submit_permute``,
bit for bit, at Context(1247, 16) and Context(100, 8), with ragged chunk
counts; the reference against csgn_tpu's permutation oracle; the
``rotate-fleet`` cell through the harness on the CPU, with its control and
faults in the timed path; the span ``perm.stack_plans`` and the counter
``perm.plan_upload_bytes``; and the cell's per-layer metric readers on
hand-made runs.  Stored ciphertexts are fresh chunks of seeded random bits
(`portbench.inputs.fresh_chunks`).  Tolerance: 0 everywhere."""

import ast
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
from csgn_tpu.ops import core as jcore
import csgn_tpu_torch as T
from csgn_tpu_torch import serve
from csgn_tpu_torch.layout import words_to_numpy
from csgn_tpu_torch.ops import dispatch
from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.utils import metrics as M
from portbench import harness, rekey_work, tracing
from portbench.inputs import fresh_chunks, host_rng, key_positions
from portbench.reference import csgn, fleet, rekey

SEED = 2**33 + 77
CELL = "rotate-fleet"
SMALL = {"shapes": [[4, 64]], "sets": 2, "readers": 4}
H100 = "NVIDIA H100 80GB HBM3"
# Kernel names as the profiler gives them, cut to the trace's 96 characters.
REGISTER = "void benes::(anonymous namespace)::benes_register_kernel<64, false>(unsigned int"
LANES = ("void benes::(anonymous namespace)::benes_lanes_kernel<64, 2, 128, false, true>"
         "(unsigned int co")
STACK = "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::"


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


def _store(counts, n, d, seed):
    """The key's positions and one stored ciphertext ``[W, t]`` of fresh
    chunks for each chunk count t of `counts`."""
    positions = key_positions(seed, n, d)
    gen = torch.Generator().manual_seed(seed)
    words = [fresh_chunks(torch.randint(0, 2, (t,), generator=gen), positions, n, gen)
             .T.contiguous() for t in counts]
    return positions, words


def _perms(b, n, seed=SEED):
    return [host_rng(seed, f"reader-{r}").permutation(n) for r in range(b)]


def _calls(rec, name, field="calls"):
    return rec.snapshot().get(name, {}).get(field, 0)


def _stacked_route(mp):
    """Every perm group through the stack, as if no group could be read in
    place."""
    mp.setattr(serve, "_reads_in_place", lambda cts: False)


@pytest.mark.parametrize("route", ["inplace", "stacked"])
@pytest.mark.parametrize("b", [3, 64])
@pytest.mark.parametrize("n,d", [(1247, 16), (100, 8)], ids=["1247x16", "100x8"])
def test_fleet_route_matches_the_reference_and_jax(rec, monkeypatch, n, d, b, route):
    """One flush of B requests of ragged chunk counts, each a tensor of its
    own under its own permutation, and the first ciphertext submitted once
    more under another reader's: one group a chunk count, on each of the
    executor's two routes; every request's words are the reference's
    rotation and the JAX executor's, and decrypt under the reader's rotated
    key to Dec_k of the stored ciphertext."""
    if route == "stacked":
        _stacked_route(monkeypatch)
    counts = np.random.default_rng(b + n).choice([1, 7, 33], size=b).tolist()
    counts[:3] = [1, 7, 33]
    positions, words = _store(counts, n, d, SEED + n)
    perms = _perms(b, n)
    ctx, jctx = T.Context(n, d), J.Context(n, d)
    cts = [T.Ciphertext(w, ctx) for w in words]
    cts.append(cts[0])
    counts, words, perms = counts + counts[:1], words + words[:1], perms + perms[1:2]
    ex, jex = T.BatchExecutor(None), J.BatchExecutor(None)
    futs = [ex.submit_permute(ct, T.Permutation(p)) for ct, p in zip(cts, perms)]
    jfuts = [jex.submit_permute(J.Ciphertext(jnp.asarray(words_to_numpy(w)), jctx),
                                J.Permutation(p)) for w, p in zip(words, perms)]
    assert ex.pending() == b + 1 and not any(f.done for f in futs)
    ex.flush()
    assert all(f.done for f in futs)
    assert ex.stats["group_dispatches"] == 3 and ex.stats["flushes"] == 1
    assert _calls(rec, "batch.permute_multi") == 3
    other = "stacked" if route == "inplace" else "inplace"
    assert (_calls(rec, f"executor.perm.{route}"), _calls(rec, f"executor.perm.{other}")) \
        == (3, 0)
    out = [f.result() for f in futs]
    parities = set()
    for o, jf, w, p in zip(out, jfuts, words, perms):
        assert torch.equal(o.wt, rekey.rotate(w, p))
        np.testing.assert_array_equal(o.to_u64(), jf.result().to_u64())
        assert fleet.check(o.wt, w, p, positions, n) == (0, 0)
        parities.add(fleet.parity(w, positions, n))
    if b == 64:
        assert parities == {0, 1}
    assert not torch.equal(out[0].wt, out[-1].wt)  # one ciphertext, two readers
    # the reference's fleet form on each group of one chunk count
    for t in set(counts):
        idx = [i for i, c in enumerate(counts) if c == t]
        got = torch.stack([out[i].wt for i in idx])
        assert torch.equal(got, fleet.rotate(torch.stack([words[i] for i in idx]),
                                             [perms[i] for i in idx]))


def _tagged(words, order, pad):
    """Each of `words` ([W, t] canonical) as a ciphertext in the physical
    chunk order `order` with `pad` zero chunks after it, all under ONE tag
    object."""
    w = words[0].shape[0]
    tag = torch.cat([torch.as_tensor(order, dtype=torch.int32),
                     torch.full((pad,), -1, dtype=torch.int32)])
    return [torch.cat([x[:, order], torch.zeros((w, pad), dtype=torch.int32)], 1)
            for x in words], tag


@pytest.mark.parametrize("case,route", [("canonical", "inplace"), ("shared_tag", "inplace"),
                                        ("mixed_tags", "stacked"),
                                        ("non_contiguous", "stacked"), ("wide", "stacked")])
def test_perm_route_choice_and_its_counters(rec, case, route):
    """A perm group goes to K9 where its requests are stored when `_stack`
    would stack them raw (all canonical, or one tag object and pad) and
    each is contiguous, on the register path (n <= 2048); mixed tags, a
    non-contiguous request and a network past the register path (n = 4095)
    take the stack.  Each group counts once under its route, and every
    request's canonical words are the reference's rotation, its tag kept
    on the in-place route."""
    n, d, t, b = (4095, 16, 9, 3) if case == "wide" else (1247, 16, 9, 4)
    _, words = _store([t] * b, n, d, SEED + b)
    perms = _perms(b, n)
    ctx = T.Context(n, d)
    order = np.random.default_rng(t).permutation(t)
    if case == "canonical" or case == "wide":
        cts = [T.Ciphertext(w, ctx) for w in words]
    elif case == "shared_tag":
        physical, tag = _tagged(words, order, 2)
        cts = [T.Ciphertext(x, ctx, tag, 2) for x in physical]
    elif case == "mixed_tags":
        physical, tag = _tagged(words[:1], order, 0)
        cts = [T.Ciphertext(physical[0], ctx, tag)] + [T.Ciphertext(w, ctx) for w in words[1:]]
    else:  # one request's words a strided view of the same values
        cts = [T.Ciphertext(w, ctx) for w in words]
        wide = torch.zeros((ctx.words32, 2 * t), dtype=torch.int32)
        wide[:, ::2] = words[1]
        object.__setattr__(cts[1], "wt", wide[:, ::2])
        assert not cts[1].wt.is_contiguous()
    ex = T.BatchExecutor(None)
    futs = [ex.submit_permute(ct, T.Permutation(p)) for ct, p in zip(cts, perms)]
    ex.flush()
    other = "stacked" if route == "inplace" else "inplace"
    assert (_calls(rec, f"executor.perm.{route}"), _calls(rec, f"executor.perm.{other}")) \
        == (1, 0)
    for fut, ct, w, p in zip(futs, cts, words, perms):
        got = fut.result()
        assert got.logical is (ct.logical if route == "inplace" else None)
        assert torch.equal(got.canonical().wt, rekey.rotate(w, p))


@pytest.mark.parametrize("n,d", [(1247, 16), (100, 8)], ids=["1247x16", "100x8"])
def test_reference_matches_the_jax_oracle(n, d):
    """On the JAX package's key and permutations: the reference's rotation of
    each element is `csgn_tpu.ops.core.permute_chunks`, and its decrypt under
    the rotated key reads the JAX key's decrypt under `apply_permutation`,
    which is Dec_k of the element."""
    jctx = J.Context(n, d)
    key = jax.random.key(25)
    jsk = J.SecretKey.generate(jctx, jax.random.fold_in(key, 0))
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2**32, (3, jctx.words32, 150), dtype=np.uint32)
    words &= jctx.valid_mask[None, :, None]
    for i, step in enumerate((2, 5, 7)):  # 75, 30 and 22 forced matches
        words[i, :, ::step] |= jsk.mask[:, None]
    jps = [J.Permutation.random(n, jax.random.fold_in(key, 1 + i)) for i in range(3)]
    perms = [np.asarray(jp.perm) for jp in jps]
    got = fleet.rotate(torch.from_numpy(words.view(np.int32)), perms)
    positions = np.asarray(jsk.indices)
    for i, (jp, perm) in enumerate(zip(jps, perms)):
        want = jcore.permute_chunks(jnp.asarray(words[i]), jnp.asarray(perm), n)
        np.testing.assert_array_equal(words_to_numpy(got[i]), np.asarray(want))
        jbit = int(jsk.apply_permutation(jp).decrypt(J.Ciphertext(want, jctx)))
        assert jbit == int(jsk.decrypt(J.Ciphertext(jnp.asarray(words[i]), jctx)))
        rotated = rekey.rotated_positions(positions, perm)
        assert fleet.parity(got[i], rotated, n) == jbit
        assert fleet.parity(torch.from_numpy(words[i].view(np.int32)), positions, n) == jbit
        assert fleet.check(got[i], torch.from_numpy(words[i].view(np.int32)), perm,
                           positions, n) == (0, 0)
    assert 1 in {fleet.parity(got[i], rekey.rotated_positions(positions, perms[i]), n)
                 for i in range(3)}


def test_reference_finds_what_differs(monkeypatch):
    """A wrong word counts once a word, a wrong bit once, and the match is
    taken in blocks that join seamlessly."""
    n, d = 1247, 16
    positions, (w,) = _store([300], n, d, SEED)
    perm = _perms(1, n)[0]
    rot = rekey.rotate(w, perm)
    bad = rot.clone()
    bad[3, 7] ^= 1 << 9
    assert fleet.check(bad, w, perm, positions, n)[0] == 1
    assert fleet.check(rekey.rotate(w, np.argsort(perm)), w, perm, positions, n)[0] > 0
    rotated = rekey.rotated_positions(positions, perm)
    mask = torch.from_numpy(csgn.mask_words(rotated, n))
    one = rot.clone()
    one[:, 0] |= mask  # chunk 0 now matches the rotated key: the bit flips (or stays)
    flips = int(not csgn.matches(rot[:, :1], mask)[0])
    assert fleet.check(one, w, perm, positions, n)[1] == flips
    with pytest.raises(ValueError):
        fleet.rotate(torch.stack([w, w]), [perm])
    whole = fleet.parity(one, rotated, n)
    monkeypatch.setattr(fleet, "MATCH_CHUNKS", 64)
    assert fleet.parity(one, rotated, n) == whole == csgn.match_count(one, mask) & 1


def test_reference_imports_nothing_of_the_program():
    """portbench/reference/fleet.py imports neither JAX nor the JAX package
    nor the port: torch, numpy and the reference's own modules alone."""
    path = pathlib.Path(harness.PKG) / "reference" / "fleet.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
            if node.level:
                names |= {f".{a.name}" for a in node.names}
    assert names == {"__future__", "torch", ".", ".csgn", ".rekey"}


def _cell(**kw):
    out, lines = harness.run_cell(CELL, SEED, 0.3, kw.pop("trace", False), device="cpu",
                                  traffic=kw.pop("traffic", SMALL), **kw)
    assert len(lines) == len(out["checks"])
    return out


def test_cell_is_correct_on_the_program(rec):
    """The cell on the CPU at 4 requests of 64 chunks a fleet, 2 sets, 4
    readers; its registered metrics; on the CPU the device readers read
    nothing and the program's span and counter do."""
    bench = harness.manifest()
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, True)} == {
        "idle.bulk", "kernel.rekey_roofline", "kernel.benes_batch_roofline",
        "perm.stack_plans_us.fleet", "perm.plan_upload_kb.fleet", "perm.inplace_share.fleet"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} == {
        "chunk_ops_per_s", "setup_s"}
    out = _cell(trace=True)
    assert out["correct"] and out["attempted"] > 0 and out["attempted"] % 4 == 0, out
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert set(out["metrics"]) == {"perm.stack_plans_us.fleet", "perm.plan_upload_kb.fleet",
                                   "perm.inplace_share.fleet"}
    assert out["metrics"]["perm.inplace_share.fleet"]["value"] == 100
    # the in-place route reads each plan where the warm-up left it: nothing
    # is uploaded in the window
    assert out["metrics"]["perm.plan_upload_kb.fleet"]["value"] == 0
    assert out["metrics"]["perm.stack_plans_us.fleet"]["value"] > 0
    assert not rec.enabled
    # untraced, the recorder stays off and empty
    assert _cell()["correct"]
    assert not rec.enabled and rec.spans() == []


def test_cell_control_rotates_wrong(rec):
    checks = {k: v["value"] for k, v in _cell(control=True)["checks"].items()}
    assert checks["rotated_words_wrong"] > 0 and checks["sets_unchecked"] == 0


def test_cell_counts_the_fleets_work(rec):
    """An op's least bytes and operations: each request read and written
    once, and the Beneš networks of its readers' plans."""
    files = harness.cell_files(CELL)
    traffic = {**files["traffic"], **SMALL}
    tracer = tracing.Tracer(False, torch.device("cpu"))
    env = harness.Env(config=files["config"], traffic=traffic, device=torch.device("cpu"),
                      seed=SEED, rate=None, positions=key_positions(SEED, 1247, 16),
                      tracer=tracer, control=False, stages=[])
    op = harness.load("ops", traffic["op"]).Op(env)
    op.setup()
    op.warm()
    perms = _perms(4, 1247)
    per_reader = [rekey_work.network_ops(T.Permutation(p).benes_plan()) for p in perms]
    assert op.fleet_ops == [64 * sum(per_reader)] * 2
    units, bytes_needed, requests, failed = op.run((0, 1), 0)
    assert (units, bytes_needed, requests, failed) == (4 * 64, 4 * 2 * 4 * 40 * 64, 4, 0)
    assert rekey_work.window_ops(tracer) == 64 * sum(per_reader)
    assert [op._reader(1, j) for j in range(4)] == [1, 2, 3, 0]
    # at the cell's size: 2^22 chunks, 1.34 GB, ≈2,022 operations a chunk
    full = files["traffic"]["shapes"][0]
    assert full == [64, 65536] and 2 * 4 * 40 * full[0] * full[1] == 1_342_177_280
    assert 2000 < sum(per_reader) / 4 < 2050


def _swap_plan(mp):
    """Request 1 of each fleet rotated with request 0's plan, on either
    route."""
    stack, requests = pb.stack_plans, dispatch.permute_requests
    mp.setattr(pb, "stack_plans", lambda plans: stack([plans[0], plans[0], *plans[2:]]))
    mp.setattr(dispatch, "permute_requests",
               lambda words, plans: requests(words, [plans[0], plans[0], *plans[2:]]))


def _flip_word(mp):
    """One bit of each fleet's last request flipped, on either route."""
    for name in ("permute_batched_multi", "permute_requests"):
        def broken(words, stacked, orig=getattr(dispatch, name)):
            out = orig(words, stacked).clone()
            out[-1, 0, -1] ^= 1 << 4
            return out
        mp.setattr(dispatch, name, broken)


@pytest.mark.parametrize("fault", [_swap_plan, _flip_word])
def test_cell_catches_a_fault_in_the_timed_path(rec, monkeypatch, fault):
    fault(monkeypatch)
    out = _cell()
    assert not out["correct"] and out["checks"]["rotated_words_wrong"]["value"] > 0


def _fleet(b=3, n=1247, d=16, chunks=5, pis=None):
    positions, words = _store([chunks] * b, n, d, SEED)
    ctx = T.Context(n, d)
    ex = T.BatchExecutor(None)
    pis = pis or [T.Permutation(p) for p in _perms(b, n)]
    futs = [ex.submit_permute(T.Ciphertext(w, ctx), p) for w, p in zip(words, pis)]
    ex.flush()
    return [f.result() for f in futs], pis


@pytest.mark.parametrize("route", ["inplace", "stacked"])
def test_stack_span_only_while_recording(rec, monkeypatch, route):
    """The plans' stack is one span under the group's, before the op; the
    requests' stack (``executor.stack``) comes first on the stacked route
    and is absent on the in-place one."""
    if route == "stacked":
        _stacked_route(monkeypatch)
    _fleet()
    assert rec.spans() == []
    with rec.recording():
        _fleet()
    spans = rec.spans()
    names = [s.name for s in spans]
    assert names.count("perm.stack_plans") == 1
    stack = spans[names.index("perm.stack_plans")]
    assert spans[stack.parent].name == "serve.perm"
    assert names.index("perm.stack_plans") < names.index("batch.permute_multi")
    if route == "stacked":
        assert names.index("executor.stack") < names.index("perm.stack_plans")
    else:
        assert "executor.stack" not in names
    assert stack.end >= stack.start
    assert not rec.enabled


def test_plan_upload_counts_cache_misses_only(rec):
    """One count a copy of a plan's or a stack's operands to a device, with
    their bytes: a plan reused uploads nothing; the executor's in-place
    route uploads each plan of a fleet once (and one schedule with every
    stage on, for its first plan), and nothing when the fleet comes again;
    a stacked batch stacks, and so uploads, its plans anew on every call."""
    p = T.Permutation(_perms(1, 1247)[0])
    plan = p.benes_plan()
    one = plan.masks.nbytes + 2 * 4 * len(plan.deltas)
    assert one == 21 * 64 * 4 + 21 * 2 * 4
    pb.device_operands(plan, "cpu")
    pb.device_operands(plan, "cpu")
    words = _store([9], 1247, 16, SEED)[1][0]
    pb.apply_benes(words, plan)
    assert (_calls(rec, "perm.plan_upload_bytes"),
            _calls(rec, "perm.plan_upload_bytes", "bytes_moved")) == (1, one)
    rec.reset()
    _, pis = _fleet(b=3)
    sched = 2 * 4 * len(plan.deltas)
    fleet = (4, 3 * one + sched)
    assert (_calls(rec, "perm.plan_upload_bytes"),
            _calls(rec, "perm.plan_upload_bytes", "bytes_moved")) == fleet
    _fleet(b=3, pis=pis)
    assert (_calls(rec, "perm.plan_upload_bytes"),
            _calls(rec, "perm.plan_upload_bytes", "bytes_moved")) == fleet
    stacked = 3 * plan.masks.nbytes + sched
    batch = T.CiphertextBatch(torch.stack(_store([5] * 3, 1247, 16, SEED)[1]), T.Context(1247, 16))
    batch.apply_permutations(pis)
    batch.apply_permutations(pis)
    assert (_calls(rec, "perm.plan_upload_bytes"),
            _calls(rec, "perm.plan_upload_bytes", "bytes_moved")) \
        == (fleet[0] + 2, fleet[1] + 2 * stacked)
    assert _calls(rec, "perm.plan_builds") == 3  # the fleet's plans, once each


def _run(device_s, ops=None, kind=H100, device_ops=(), fleets=0):
    tracer = tracing.Tracer(False, torch.device("cpu"))
    tracer.spans += [("rotate.fleet", float(i), i + 0.5) for i in range(fleets)]
    if ops is not None:
        rekey_work.add_ops(tracer, ops)
    return types.SimpleNamespace(device_kind=kind, bytes_needed=1, tracer=tracer,
                                 trace=types.SimpleNamespace(device_s=device_s,
                                                             device_ops=list(device_ops)))


def test_batch_roofline_reader_reads_the_register_kernel_alone():
    """K9's share: the window's network operations over the int32 rate
    against the register kernel's own device time; None where no register
    kernel ran, where the op counted no operations or the card has no
    peak."""
    read = harness.load("metrics", "kernel.benes_batch_roofline").read
    ops = 2022 * (1 << 22) * 1000                      # 1,000 fleets
    rate = rekey_work.INT32_OPS_PER_S[H100]
    trace = [[REGISTER, 0.83], [STACK, 0.45], ["Memcpy HtoD (Pageable -> Device)", 0.01]]
    run = _run(1.29, ops, device_ops=trace)
    assert read(run) == pytest.approx(100 * (ops / rate) / 0.83)
    assert read(run) == pytest.approx(61.1, abs=0.1)  # 0.507 of 0.83 ms a fleet
    whole = harness.load("metrics", "kernel.rekey_roofline").read(run)
    assert read(run) > whole == pytest.approx(100 * (ops / rate) / 1.29)
    two = _run(1.29, ops, device_ops=[[REGISTER, 0.4], [REGISTER + "x", 0.43], *trace[1:]])
    assert read(two) == pytest.approx(read(run))
    assert read(_run(1.29, ops, device_ops=[[LANES, 0.83], *trace[1:]])) is None
    assert read(_run(1.29, None, device_ops=trace)) is None
    assert read(_run(1.29, ops, kind="cpu", device_ops=trace)) is None
    run.trace = None
    assert read(run) is None


def test_stack_plans_reader_reads_the_spans_over_the_fleets(rec):
    read = harness.load("metrics", "perm.stack_plans_us.fleet").read
    assert read(_run(1.0, fleets=2)) is None  # a program without the span
    with rec.recording():
        for _ in range(3):
            with rec.span("perm.stack_plans"):
                pass
            with rec.span("perm.plan"):
                pass
    want = sum(s.seconds for s in rec.spans() if s.name == "perm.stack_plans")
    assert read(_run(1.0, fleets=3)) == pytest.approx(1e6 * want / 3)
    assert read(_run(1.0, fleets=0)) is None
    run = _run(1.0, fleets=3)
    run.tracer = None
    assert read(run) is None


def test_plan_upload_reader_reads_the_counter_over_the_fleets(rec):
    read = harness.load("metrics", "perm.plan_upload_kb.fleet").read
    assert read(_run(1.0, fleets=2)) is None  # a program without the counter
    rec.count("perm.plan_upload_bytes", bytes_moved=344_232)
    rec.count("perm.plan_upload_bytes", bytes_moved=344_232)
    assert read(_run(1.0, fleets=2)) == pytest.approx(344.232)
    assert read(_run(1.0, fleets=4)) == pytest.approx(172.116)
    assert read(_run(1.0, fleets=0)) is None


def test_inplace_share_reader_reads_the_route_counters(rec):
    """The in-place groups' share of the window's perm groups; None in a
    program without either counter."""
    read = harness.load("metrics", "perm.inplace_share.fleet").read
    assert read(_run(1.0, fleets=2)) is None
    for _ in range(4):
        rec.count("executor.perm.inplace")
    assert read(_run(1.0, fleets=4)) == 100
    rec.count("executor.perm.stacked")
    assert read(_run(1.0, fleets=5)) == pytest.approx(80)
    rec.reset()
    rec.count("executor.perm.stacked")
    assert read(_run(1.0, fleets=1)) == 0
