"""The port's benchmark program (`csgn_tpu_torch.bench`) on the CPU, against
the JAX package's bench.py.

The operands must be bench.py's draws, word for word; the guards' results
(the product head, the fused product and parity, the decrypt parity, the
chained decrypt, the permuted chunks, the serving bits, the AES fleet's
blocks) must equal the JAX package's on those operands.  One subprocess runs
the whole program with ``--device cpu`` and reads its one JSON line, with
the keys of bench.py's line; a wrong AES block must raise and print no line.
Tolerance: exact.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgn_tpu.ciphertext import Ciphertext as JCiphertext
from csgn_tpu.context import Context as JContext
from csgn_tpu.models.aes import aes128 as jaes128
from csgn_tpu.models.netlist import bits_from_bytes as jbits_from_bytes
from csgn_tpu.models.netlist import bytes_from_bits as jbytes_from_bits
from csgn_tpu.models.netlist import eval_plain as jeval_plain
from csgn_tpu.ops import core as jcore
from csgn_tpu.secret_key import SecretKey as JSecretKey
from csgn_tpu.serve import BatchExecutor as JBatchExecutor
from csgn_tpu_torch import bench, convert, rng
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.models.aes import aes128

REPO = pathlib.Path(__file__).resolve().parent.parent
CTX, JCTX = Context(1247, 16), JContext(1247, 16)
TINY = bench.Sizes(t=8, dec_chunks=256, enc_batch=64, enc_k=1, perm_chunks=64, perm_k=2,
                   serve_requests=2, aes_fleet=2)


def bench_py_keys() -> set:
    """The keys of the JSON line in bench.py's source (its json.dumps dict)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("bench.py has no JSON line dict")


def bench_py_draws(ctx: JContext, t: int, dec_chunks: int, enc_batch: int, pc: int,
                   s_req: int) -> dict:
    """bench.py's numpy calls, in its order (bench.py:142, 159-164, 232, 309,
    343, 346, 419-420), on the JAX package's Context."""
    w = ctx.words32
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (w, t), dtype=np.uint32) & ctx.valid_mask[:, None]
    b = rng.integers(0, 2**32, (w, t), dtype=np.uint32) & ctx.valid_mask[:, None]
    mask_np = np.zeros(w, np.uint32)
    for pos in (np.arange(ctx.d) * 71 + 5) % ctx.n:
        mask_np[pos // 32] |= np.uint32(1) << (31 - pos % 32)
    big = rng.integers(0, 2**32, (w, dec_chunks), dtype=np.uint32)
    bits = rng.integers(0, 2, enc_batch, dtype=np.uint8)
    perm = rng.permutation(ctx.n)
    px = rng.integers(0, 2**32, (w, pc), dtype=np.uint32) & ctx.valid_mask[:, None]
    pw = rng.integers(0, 2**32, (2 * s_req, w, 2), dtype=np.uint32) \
        & np.asarray(ctx.valid_mask)[None, :, None]
    return {"a": a, "b": b, "mask": mask_np, "big": big, "bits": bits, "perm": perm, "px": px,
            "pw": pw}


@pytest.fixture(scope="module")
def ops():
    return bench.operands(CTX, bench.CPU)


def _cpu(words: np.ndarray) -> torch.Tensor:
    return words_from_numpy(words, "cpu")


@pytest.mark.parametrize("sizes", [bench.CPU, TINY], ids=["cpu", "tiny"])
def test_operands_are_bench_py_draws(sizes):
    got = bench.operands(CTX, sizes)
    want = bench_py_draws(JCTX, sizes.t, sizes.dec_chunks, sizes.enc_batch, sizes.perm_chunks,
                          sizes.serve_requests)
    for name, arr in want.items():
        mine = getattr(got, name)
        assert mine.dtype == arr.dtype and np.array_equal(mine, arr), name
    assert np.count_nonzero(got.mask) == 16  # the rows K3 reads on the card


def test_product_guards_equal_the_jax_package(ops):
    head, prod, parity = bench.check_product(_cpu(ops.a), _cpu(ops.b), _cpu(ops.mask))
    ja, jb = jnp.asarray(ops.a), jnp.asarray(ops.b)
    assert np.array_equal(words_to_numpy(head), np.asarray(jcore.mul_chunks(ja[:, :1], jb)))
    j4 = jcore.mul_chunks(ja[:, :4], jb)
    assert np.array_equal(words_to_numpy(prod), np.asarray(j4))
    assert int(parity) == int(jcore.decrypt_parity(j4, jnp.asarray(ops.mask)))
    assert int(bench.check_decrypt(_cpu(ops.big), _cpu(ops.mask))) == int(
        jcore.decrypt_parity(jnp.asarray(ops.big[:, :1024]), jnp.asarray(ops.mask)))


@pytest.mark.parametrize("forced", [False, True], ids=["as-drawn", "one-more-match"])
def test_decrypt_chain_equals_the_jax_scan(ops, forced):
    """bench.py:237-243's chain; with one more matching chunk the first
    parity flips, and the masks alternate between `mask` and `mask ^ 1`."""
    big = ops.big.copy()
    if forced:
        matches = (big & ops.mask[:, None]) == ops.mask[:, None]
        col = int(np.flatnonzero(~matches.all(axis=0))[0])
        big[:, col] |= ops.mask
    got = bench.decrypt_chain(_cpu(big), _cpu(ops.mask), bench.K).tolist()
    jbig, jmask = jnp.asarray(big), jnp.asarray(ops.mask)
    carry, want = jnp.uint32(0), []
    for _ in range(bench.K):
        carry = jcore.decrypt_parity(jbig, jmask ^ carry)
        want.append(int(carry))
    assert got == want
    assert want[:2] == ([1, 0] if forced else [0, 0])


def test_permute_guard_equals_the_jax_gather(ops):
    plan = convert.permutation_from_numpy(ops.perm).benes_plan()
    got = bench.check_permute(_cpu(ops.px), ops.perm, plan)
    want = jcore.permute_chunks(jnp.asarray(ops.px[:, :256]), jnp.asarray(ops.perm), CTX.n)
    assert np.array_equal(words_to_numpy(got), np.asarray(want))


def test_serve_bits_equal_the_jax_executor(ops):
    sk = bench.secret_key(CTX, "cpu")
    jsk = JSecretKey.generate(JCTX, jax.random.key(0))          # bench.py:307
    assert np.array_equal(sk.indices, jsk.indices)
    pairs = bench.serve_pairs(CTX, ops.pw, "cpu")
    loop, flush = bench.serve_loop(sk, pairs), bench.serve_flush(sk, pairs)
    ex = JBatchExecutor(jsk)
    futs = [ex.submit_mul_decrypt(JCiphertext(jnp.asarray(ops.pw[2 * i]), JCTX),
                                  JCiphertext(jnp.asarray(ops.pw[2 * i + 1]), JCTX))
            for i in range(len(ops.pw) // 2)]
    ex.flush()
    assert loop == flush == [int(f.result()[1]) for f in futs]


def test_aes_fleet_blocks_at_a_small_fleet():
    sk = bench.secret_key(CTX, "cpu")
    netlist, bit_mat = aes128(), bench.aes_fleet_inputs(3)
    blocks = bench.aes_fleet_blocks(sk, netlist, bit_mat, sk.encrypt(1, rng.key(0xF1)),
                                    rng.key(0xF2))
    assert blocks[0].hex() == bench.FIPS197_C1
    assert blocks == bench.aes_fleet_plain(netlist, bit_mat)
    key1 = bytes((7 + i) % 256 for i in range(16))
    assert bit_mat[:, 1].tolist() == jbits_from_bytes(key1 + bench.AES_BLOCK)
    (want,) = jeval_plain(jaes128(), [bit_mat[:128, 1].tolist(), bit_mat[128:, 1].tolist()])
    assert blocks[1] == jbytes_from_bits(want)


def test_program_prints_one_line_with_bench_py_keys():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "csgn_tpu_torch.bench", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [line for line in res.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert set(out) == bench_py_keys()
    assert out["value"] > 0 and out["groups"] >= 4 and out["perm_block_c"] is None
    assert out["enc_suspect"] is False and out["aes_fleet_blocks_per_s"] > 0
    assert "aes fleet: B=64" in res.stderr and "device=cpu" in res.stderr


@pytest.mark.parametrize("fault", ["fips", "member"])
def test_a_wrong_aes_block_raises_and_prints_no_line(monkeypatch, capsys, fault):
    monkeypatch.setattr(bench, "CPU", TINY)
    if fault == "fips":
        monkeypatch.setattr(bench, "FIPS197_C1", "00" * 16)
    else:
        right = bench.aes_fleet_blocks

        def wrong(*args):
            blocks = right(*args)
            return blocks[:1] + [bytes([blocks[1][0] ^ 1]) + blocks[1][1:]] + blocks[2:]

        monkeypatch.setattr(bench, "aes_fleet_blocks", wrong)
    with pytest.raises(bench.BenchFailure, match="FIPS-197" if fault == "fips" else "plaintext"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""
