"""The port's netlist layer and circuit models against csgn_tpu.models,
bit-exactly: the Bristol fixtures in tests/circuits/ parsed from disk,
`to_text`, the generators (adder, equality, comparator, AES-128, SHA-256)
gate for gate, `eval_plain`/`eval_plain_packed`, `eval_homomorphic` and
`eval_homomorphic_batch` words given the same input words and NOT-constant,
AES-128 (FIPS-197 C.1) through `eval_expr` + `decrypt_circuits` at a fleet
of 2, SHA-256 against hashlib, and `Gates`, `matvec_f2`, `private_lookup`.
Tolerance: 0.
"""

import hashlib
import pathlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import models as jm
from csgn_tpu.batch import CiphertextBatch as JBatch
from csgn_tpu.models import netlist as jn
from csgn_tpu_torch import convert, models as tm
from csgn_tpu_torch.models import netlist as tn
from csgn_tpu_torch.models.sha256 import SHA256_IV, sha256_pad_one_block

CIRCUITS = pathlib.Path(__file__).parent / "circuits"
FIPS = ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
        "69c4e0d86a7b0430d8cdb78070b4c55a")


def _fields(nl):
    return (nl.n_wires, nl.input_sizes, nl.output_sizes,
            [(g.op, g.ins, g.out) for g in nl.gates])


@pytest.mark.parametrize("name", ["adder64.txt", "gt32.txt", "aes_sbox.txt", "mand3.txt"])
def test_fixtures_parse_like_jax(name):
    text = (CIRCUITS / name).read_text()
    expand = name == "mand3.txt"
    if expand:
        for parse in (jn.Netlist.parse, tn.Netlist.parse):
            with pytest.raises(ValueError, match="MAND"):
                parse(text)
    t, j = tn.Netlist.parse(text, expand_mand=expand), jn.Netlist.parse(text, expand_mand=expand)
    assert _fields(t) == _fields(j)
    assert t.to_text() == j.to_text()
    assert _fields(tn.Netlist.parse(t.to_text())) == _fields(t)
    assert convert.netlist_from_text(j.to_text()) == t
    assert (t.and_count, t.growth(), t.peak_chunks(2, 3)) == \
        (j.and_count, j.growth(), j.peak_chunks(2, 3))


@pytest.mark.parametrize("gen", ["adder", "equality", "comparator_gt"])
@pytest.mark.parametrize("width", [1, 5, 16])
def test_generators_match_jax(gen, width):
    assert _fields(getattr(tn, gen)(width)) == _fields(getattr(jn, gen)(width))


def test_flagship_generators_match_jax():
    for name in ("aes128", "sha256_compress"):
        t, j = getattr(tm, name)(), getattr(jm, name)()
        assert _fields(t) == _fields(j), name


def test_eval_plain_and_packed_match_jax():
    rng = np.random.default_rng(4)
    nl_t, nl_j = tn.comparator_gt(8), jn.comparator_gt(8)
    for _ in range(20):
        ins = [list(rng.integers(0, 2, 8)), list(rng.integers(0, 2, 8))]
        assert tn.eval_plain(nl_t, ins) == jn.eval_plain(nl_j, ins)
    add_t, add_j = tn.adder(6), jn.adder(6)
    packed = [[int(x) for x in rng.integers(0, 1 << 40, 6)] for _ in range(2)]
    assert tn.eval_plain_packed(add_t, packed, 40) == jn.eval_plain_packed(add_j, packed, 40)
    assert tn.bits_from_bytes(b"\x01\x80") == jn.bits_from_bytes(b"\x01\x80")
    assert tn.bytes_from_bits(tn.bits_from_bytes(b"xyz")) == b"xyz"


def _keys(ctx, seed):
    idx = np.random.default_rng(seed).choice(ctx.n, ctx.d, replace=False).astype(np.int32)
    tctx = T.Context(ctx.n, ctx.d)
    return J.SecretKey(ctx, idx), convert.secret_key_from_numpy(tctx, idx, device="cpu"), tctx


def _words(jsk, bits, seed):
    return np.asarray(jsk.encrypt_batch(jnp.asarray(np.asarray(bits, np.uint8)), seed,
                                        engine="counter"))


def test_eval_homomorphic_and_batch_match_jax(small_ctx):
    """comparator_gt(3) has INV gates: the NOT-constant is the same words on
    both sides.  The batched form equals the 2-D form per element."""
    jsk, tsk, tctx = _keys(small_ctx, 2)
    nl_t, nl_j = tn.comparator_gt(3), jn.comparator_gt(3)
    one = _words(jsk, [1, 1, 1], 40)                       # a 3-chunk encryption of 1
    jone = J.Ciphertext(jnp.asarray(one), small_ctx)
    tone = convert.ciphertext_from_numpy(one, tctx, "cpu")
    bits = np.random.default_rng(0).integers(0, 2, (4, 2, 3))   # 4 requests
    bits[0] = [[1, 1, 0], [0, 1, 0]]                           # 3 > 2
    w = [[_words(jsk, bits[r, v], 100 + 10 * r + v) for v in range(2)] for r in range(4)]

    def wires(r, v, make):
        return [make(w[r][v][:, k:k + 1]) for k in range(3)]

    for r in range(4):
        jin = [wires(r, v, lambda x: J.Ciphertext(jnp.asarray(x), small_ctx)) for v in range(2)]
        tin = [wires(r, v, lambda x: convert.ciphertext_from_numpy(x, tctx, "cpu"))
               for v in range(2)]
        (jout,) = jn.eval_homomorphic(nl_j, jin, jm.Gates(jone))[0]
        (tout,) = tn.eval_homomorphic(nl_t, tin, tm.Gates(tone))[0]
        np.testing.assert_array_equal(tout.to_u64(), jout.to_u64())
        want = tn.eval_plain(nl_t, [bits[r, 0], bits[r, 1]])[0][0]
        assert int(tsk.decrypt(tout)) == want == (1 if r == 0 else want)

    jin = [[JBatch(jnp.asarray(np.stack([w[r][v][:, k:k + 1] for r in range(4)])), small_ctx)
            for k in range(3)] for v in range(2)]
    tin = [[convert.ciphertext_batch_from_numpy(np.stack([w[r][v][:, k:k + 1]
                                                          for r in range(4)]), tctx, device="cpu")
            for k in range(3)] for v in range(2)]
    (jb,) = jn.eval_homomorphic_batch(nl_j, jin, jone)[0]
    (tb,) = tn.eval_homomorphic_batch(nl_t, tin, tone)[0]
    np.testing.assert_array_equal(tb.to_u64(), jb.to_u64())
    for r in range(4):
        (single,) = tn.eval_homomorphic(nl_t, [[tb_in[r] for tb_in in tin[v]] for v in range(2)],
                                        tm.Gates(tone))[0]
        np.testing.assert_array_equal(tb[r].to_u64(), single.to_u64())


def test_budget_refusal_names_both_knobs(small_ctx):
    """Repaired in the port: the refusal names `budget_bytes` and the
    executor's `netlist_budget_bytes`; the JAX package names only the first."""
    jsk, tsk, tctx = _keys(small_ctx, 3)
    one = _words(jsk, [1], 1)
    inputs_w = [[_words(jsk, [b], 10 + 4 * v + k) for k, b in enumerate([1, 0, 1, 1])]
                for v in range(2)]
    nl_t, nl_j = tn.adder(4), jn.adder(4)
    jin = [[J.Ciphertext(jnp.asarray(x), small_ctx) for x in v] for v in inputs_w]
    tin = [[convert.ciphertext_from_numpy(x, tctx, device="cpu") for x in v] for v in inputs_w]
    with pytest.raises(ValueError, match="budget") as jerr:
        jn.eval_homomorphic(nl_j, jin, jm.Gates(J.Ciphertext(jnp.asarray(one), small_ctx)),
                            budget_bytes=64)
    with pytest.raises(ValueError, match="budget") as terr:
        tn.eval_homomorphic(nl_t, tin, tm.Gates(convert.ciphertext_from_numpy(one, tctx, "cpu")),
                            budget_bytes=64)
    assert "netlist_budget_bytes" not in str(jerr.value)
    assert "budget_bytes=" in str(terr.value)
    assert "BatchExecutor(netlist_budget_bytes=...)" in str(terr.value)


def test_aes_fips197_through_eval_expr_at_a_fleet_of_2(small_ctx):
    jsk, tsk, tctx = _keys(small_ctx, 5)
    aes = tm.aes128()
    key_pt = [tn.bits_from_bytes(bytes.fromhex(FIPS[0])) + tn.bits_from_bytes(bytes.fromhex(FIPS[1])),
              list(np.random.default_rng(1).integers(0, 2, 256))]
    words = tsk.encrypt_batch(np.array(key_pt).T.reshape(-1), 77)     # wire-major, 2 per wire
    leaves = [T.CiphertextBatch(words[:, 2 * j:2 * j + 2].t().reshape(2, -1, 1), tctx)
              for j in range(256)]
    one = tsk.encrypt(1, 78)
    (out,) = tn.eval_expr(aes, [leaves[:128], leaves[128:]], one)
    bits = tsk.decrypt_circuits(out)
    got = np.stack(bits)                                   # [128, 2]
    assert tn.bytes_from_bits(list(got[:, 0])).hex() == FIPS[2]
    want = tn.eval_plain(aes, [key_pt[1][:128], key_pt[1][128:]])[0]
    assert list(got[:, 1]) == want


def test_sha256_one_block_via_eval_plain_packed():
    nl = tm.sha256_compress()
    iv = b"".join(struct.pack(">I", h) for h in SHA256_IV)
    msgs = [b"", b"abc", b"csgn_tpu_torch"]
    rows = [tn.bits_from_bytes(sha256_pad_one_block(m)) + tn.bits_from_bytes(iv) for m in msgs]
    packed = [sum(rows[r][k] << r for r in range(len(msgs))) for k in range(768)]
    (out,) = tn.eval_plain_packed(nl, [packed[:512], packed[512:]], len(msgs))
    for r, m in enumerate(msgs):
        assert tn.bytes_from_bits([(v >> r) & 1 for v in out]) == hashlib.sha256(m).digest()


def test_gates_linear_and_lookup_match_jax(small_ctx):
    jsk, tsk, tctx = _keys(small_ctx, 6)
    rng = np.random.default_rng(6)
    bits = [1, 0, 1, 1, 0]
    cols = _words(jsk, bits, 60)
    one_w = _words(jsk, [1], 61)
    jc = [J.Ciphertext(jnp.asarray(cols[:, k:k + 1]), small_ctx) for k in range(5)]
    tc = [convert.ciphertext_from_numpy(cols[:, k:k + 1], tctx, device="cpu") for k in range(5)]
    jg = jm.Gates(J.Ciphertext(jnp.asarray(one_w), small_ctx))
    tg = tm.Gates(convert.ciphertext_from_numpy(one_w, tctx, device="cpu"))

    def same(t, j):
        np.testing.assert_array_equal(t.to_u64(), j.to_u64())

    for op in ("or_", "nand", "nor", "xnor"):
        same(getattr(tg, op)(tc[0], tc[1]), getattr(jg, op)(jc[0], jc[1]))
    same(tg.mux(tc[0], tc[1], tc[2]), jg.mux(jc[0], jc[1], jc[2]))
    same(tg.parity(tc), jg.parity(jc))
    same(tg.equals(tc[:2], tc[2:4]), jg.equals(jc[:2], jc[2:4]))
    (ts, tcar), (js, jcar) = tg.ripple_add(tc[:2], tc[2:4]), jg.ripple_add(jc[:2], jc[2:4])
    for t, j in zip(ts + [tcar], js + [jcar]):
        same(t, j)
    assert int(tsk.decrypt(tg.mux(tc[0], tc[1], tc[2]))) == 0   # sel 1 -> a = 0

    matrix = rng.integers(0, 2, (4, 5))
    matrix[:, 0] = 1
    for t, j in zip(tm.matvec_f2(matrix, tc), jm.matvec_f2(matrix, jc)):
        same(t, j)
    assert [int(tsk.decrypt(c)) for c in tm.matvec_f2(matrix, tc)] == \
        list((matrix @ np.array(bits)) % 2)
    with pytest.raises(ValueError, match="selects no inputs"):
        tm.matvec_f2(np.zeros((1, 5), int), tc)

    table = [0, 1, 1, 0, 1, 0, 0, 1]
    for addr in range(8):
        abits = [(addr >> k) & 1 for k in range(3)]
        aw = _words(jsk, abits, 200 + addr)
        ja = [J.Ciphertext(jnp.asarray(aw[:, k:k + 1]), small_ctx) for k in range(3)]
        ta = [convert.ciphertext_from_numpy(aw[:, k:k + 1], tctx, device="cpu") for k in range(3)]
        t, j = tm.private_lookup(tg, ta, table), jm.private_lookup(jg, ja, table)
        same(t, j)
        assert int(tsk.decrypt(t)) == table[addr]
