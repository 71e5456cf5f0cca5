"""Guards of the port: it never imports JAX or csgn_tpu, its kernel wrappers
reject what the kernels do not take, and its CUDA-only tests skip cleanly
here."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from csgn_tpu_torch import Ciphertext, Context, Permutation, SecretKey
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import benes_kernels, encrypt_kernels, kernels
from csgn_tpu_torch.ops import permute_benes as pb

REPO = pathlib.Path(__file__).resolve().parent.parent
CTX = Context(95, 4)


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300, check=False, **kw)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, csgn_tpu_torch, csgn_tpu_torch.convert, csgn_tpu_torch.ops.dispatch, "
        "csgn_tpu_torch.ops.encrypt_kernels, csgn_tpu_torch.utils, csgn_tpu_torch.batch, "
        "csgn_tpu_torch.permutation, csgn_tpu_torch.ops.benes_kernels, "
        "csgn_tpu_torch.ops.permute_benes, csgn_tpu_torch.pipeline, csgn_tpu_torch.circuit, "
        "csgn_tpu_torch.serve, csgn_tpu_torch.models, csgn_tpu_torch.models.netlist, "
        "csgn_tpu_torch.models.aes, csgn_tpu_torch.models.sha256, "
        "csgn_tpu_torch.models.circuits, csgn_tpu_torch.models.linear, "
        "csgn_tpu_torch.models.lookup, csgn_tpu_torch.cli, csgn_tpu_torch.config, "
        "csgn_tpu_torch.io, csgn_tpu_torch.utils.timing, csgn_tpu_torch.utils.checks, "
        "csgn_tpu_torch.tools.enc_stats, csgn_tpu_torch.rng, csgn_tpu_torch.refcompat, "
        "csgn_tpu_torch.parallel, csgn_tpu_torch.parallel.mesh, "
        "csgn_tpu_torch.parallel.multihost, csgn_tpu_torch.parallel.ops, "
        "csgn_tpu_torch.parallel.batch_ops, csgn_tpu_torch.parallel.dryrun; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'csgn_tpu.')) "
        "or m == 'csgn_tpu'); print(bad); sys.exit(1 if bad else 0)"
    )
    res = _run([sys.executable, "-c", code])
    assert res.returncode == 0, res.stdout + res.stderr


def _words(chunks, seed=0):
    rng = np.random.default_rng(seed)
    return words_from_numpy(rng.integers(0, 2**32, (CTX.words32, chunks), dtype=np.uint32), "cpu")


@pytest.mark.parametrize("fn", ["mul_chunks", "mul_decrypt"])
def test_mul_wrappers_reject_bad_operands(fn):
    a, b = _words(3), _words(4, 1)
    mask = words_from_numpy(CTX.valid_mask, device="cpu")
    call = (lambda x, y, m=mask: kernels.mul_decrypt(x, y, m)) if fn == "mul_decrypt" \
        else (lambda x, y: kernels.mul_chunks(x, y))
    with pytest.raises(TypeError, match="int32"):
        call(a.to(torch.int64), b)
    with pytest.raises(ValueError, match=r"\[W, chunks\]"):
        call(a, b[:-1])
    with pytest.raises(ValueError, match=r"\[W, chunks\]"):
        call(a.reshape(-1), b)
    with pytest.raises(ValueError, match="contiguous"):
        call(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="device"):
        call(a.to("meta"), b)
    with pytest.raises(TypeError, match="torch.Tensor"):
        call(a.numpy(), b)
    if fn == "mul_decrypt":
        with pytest.raises(ValueError, match="mask"):
            kernels.mul_decrypt(a, b, mask[:-1])


@pytest.mark.parametrize("fn", ["decrypt_parity", "chunk_matches"])
def test_decrypt_wrappers_reject_bad_operands(fn):
    words, mask = _words(5), words_from_numpy(CTX.valid_mask, device="cpu")
    call = getattr(kernels, fn)
    with pytest.raises(TypeError, match="int32"):
        call(words, mask.to(torch.int64))
    with pytest.raises(ValueError, match="mask"):
        call(words, mask[None])
    with pytest.raises(ValueError, match="device"):
        call(words, mask.to("meta"))


def test_encrypt_wrapper_rejects_bad_operands():
    sk = SecretKey(CTX, [1, 5, 9, 70], device="cpu")
    idx, mask, valid = sk.encrypt_operands
    good = (torch.tensor([1, 0]), idx, mask, valid)
    assert encrypt_kernels.encrypt_bits_counter(1, *good).shape == (CTX.words32, 2)
    with pytest.raises(TypeError, match="int32"):
        encrypt_kernels.encrypt_bits_counter(1, good[0], idx.long(), *good[2:])
    with pytest.raises(TypeError, match="bits"):
        encrypt_kernels.encrypt_bits_counter(1, torch.tensor([1.0]), *good[1:])
    with pytest.raises(ValueError, match="1-D"):
        encrypt_kernels.encrypt_bits_counter(1, torch.ones(2, 2, dtype=torch.int32), *good[1:])
    with pytest.raises(ValueError, match="device"):
        encrypt_kernels.encrypt_bits_counter(1, good[0].to("meta"), *good[1:])
    with pytest.raises(ValueError, match="valid_mask"):
        encrypt_kernels.encrypt_bits_counter(1, *good[:3], valid[:-1])


def test_philox_wrappers_reject_bad_operands():
    sk = SecretKey(CTX, [1, 5, 9, 70], device="cpu")
    idx, mask, valid = sk.encrypt_operands
    good = (torch.tensor([1, 0]), idx, mask, valid)
    assert encrypt_kernels.encrypt_bits_philox(1, *good).shape == (CTX.words32, 2)
    with pytest.raises(TypeError, match="encrypt_bits_philox: key_idx must be int32"):
        encrypt_kernels.encrypt_bits_philox(1, good[0], idx.long(), *good[2:])
    with pytest.raises(ValueError, match="device"):
        encrypt_kernels.encrypt_bits_philox(1, good[0].to("meta"), *good[1:])
    with pytest.raises(ValueError, match="valid_mask"):
        encrypt_kernels.encrypt_bits_philox(1, *good[:3], valid[:-1])
    with pytest.raises(ValueError, match="batch"):
        encrypt_kernels.philox_streams(1, -1, 6, device="cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        encrypt_kernels.philox_streams(1, 4, 6, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.fill_anchor(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="negative"):
        kernels.fill_anchor(1, -2, 3, 4, device="cpu")


def test_entry_points_default_to_the_card():
    """Without a device, the constructors and converters land on the current
    CUDA device; on a machine without one they raise, naming device="cpu",
    and never fall back to the CPU."""
    from csgn_tpu_torch import convert, layout
    from csgn_tpu_torch.ops import encrypt_kernels as ek

    words = np.zeros((CTX.words32, 2), np.uint32)
    calls = [
        lambda: SecretKey(CTX, [1, 5, 9, 70]),
        lambda: SecretKey.generate(CTX, torch.Generator().manual_seed(0)),
        lambda: Ciphertext.from_u64(np.zeros(2 * CTX.words64, np.uint64), CTX),
        lambda: Ciphertext.from_chunk_major(words.T, CTX),
        lambda: convert.secret_key_from_numpy(CTX, [1, 5, 9, 70]),
        lambda: convert.ciphertext_from_numpy(words, CTX),
        lambda: convert.ciphertext_batch_from_numpy(words[None], CTX),
        lambda: layout.words_from_numpy(words),
        lambda: ek.philox_streams(1, 4, 6),
        lambda: kernels.fill_anchor(1, 2, 2, 4),
    ]
    if torch.cuda.is_available():
        sk = calls[0]()
        assert sk.device.type == "cuda" and sk.mask_words.is_cuda
        for call in calls[1:]:
            out = call()
            dev = getattr(out, "device", None) or out.wt.device
            assert dev.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match='pass device="cpu" to run on the CPU'):
                call()


def test_decrypt_batch_guards():
    sk = SecretKey(CTX, [1, 5, 9, 70], device="cpu")
    words = sk.encrypt_batch([1, 0, 1, 1, 0, 1], 3)
    assert sk.decrypt_batch(words).tolist() == [1, 0, 1, 1, 0, 1]
    with pytest.raises(ValueError, match="transposed"):
        sk.decrypt_batch(words.t().contiguous())
    # A grown [batch, W, chunks] payload decrypts per element (parity of 6).
    assert sk.decrypt_batch(words[None]).tolist() == [0]
    assert sk.decrypt_batch(torch.stack([words, words[:, :3].contiguous().repeat(1, 2)])
                            ).tolist() == [0, 0]
    with pytest.raises(ValueError, match=r"\[batch, W=4, chunks\]"):
        sk.decrypt_batch(words.t()[None])
    with pytest.raises(TypeError):
        sk.decrypt_batch(words.numpy())


def test_benes_wrappers_reject_bad_operands():
    plan = Permutation.random(CTX, torch.Generator().manual_seed(0)).benes_plan()
    words, mask = _words(5), words_from_numpy(CTX.valid_mask, device="cpu")
    stacked = pb.stack_plans([plan, plan])
    assert benes_kernels.apply_benes(words, plan).shape == words.shape
    with pytest.raises(TypeError, match="int32"):
        benes_kernels.apply_benes(words.long(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        benes_kernels.apply_benes(_words(5).t().contiguous().t(), plan)
    with pytest.raises(ValueError, match="device"):
        benes_kernels.apply_benes(words.to("meta"), plan)
    with pytest.raises(ValueError, match=r"\[k=2, W, C\]"):
        benes_kernels.apply_benes_batch(words, stacked)
    with pytest.raises(ValueError, match=r"\[k=2, W, C\]"):
        benes_kernels.apply_benes_batch(torch.stack([words] * 3), stacked)
    with pytest.raises(ValueError, match="mask"):
        benes_kernels.apply_benes_decrypt(words, plan, mask[:-1])
    with pytest.raises(ValueError, match=r"\[W, chunks\]"):
        benes_kernels.apply_benes_decrypt(words[None], plan, mask)
    with pytest.raises(ValueError, match="no plans"):
        pb.stack_plans([])
    with pytest.raises(ValueError, match="share n"):
        pb.stack_plans([plan, Permutation.identity(94).benes_plan()])


def test_key_and_ciphertext_guards():
    with pytest.raises(ValueError, match="distinct"):
        SecretKey(CTX, [1, 1, 2, 3], device="cpu")
    with pytest.raises(ValueError, match="range"):
        SecretKey(CTX, [1, 2, 3, 95], device="cpu")
    sk = SecretKey(CTX, [1, 5, 9, 70], device="cpu")
    with pytest.raises(ValueError, match=r"\[W=4, chunks\]"):
        Ciphertext(sk.encrypt_batch([1], 1).t().contiguous(), CTX)
    other = SecretKey(Context(1247, 16), np.arange(16), device="cpu")
    with pytest.raises(ValueError, match="context"):
        other.decrypt(sk.encrypt(1, 1))


def test_cuda_tests_skip_with_reason_without_a_gpu():
    """Without a card, every test of tests/test_torch_cuda.py skips with the
    stated reason (and the file collects without JAX: --noconftest)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: tests/test_torch_cuda.py runs instead")
    res = _run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                "-q", "-rs", "tests/test_torch_cuda.py"])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    reasons = re.findall(r"SKIPPED \[(\d+)\] \S+: (.*)", out)
    assert reasons and {r for _, r in reasons} == {"needs an NVIDIA GPU"}, out
    assert not re.search(r"\d+ (passed|failed|error)", out), out


def test_order_tag_api():
    """The JAX package's order-tag names exist: every product of the port is
    canonical with no pad chunks, and `set_eager_order` keeps the flag and
    returns the previous setting, changing no result."""
    import csgn_tpu_torch
    from csgn_tpu_torch import CiphertextBatch, set_eager_order

    assert csgn_tpu_torch.set_eager_order is set_eager_order
    sk = SecretKey(CTX, [1, 5, 9, 70], device="cpu")
    a = Ciphertext(sk.encrypt_batch([1, 0, 1], 3), CTX)
    b = Ciphertext(sk.encrypt_batch([1, 1, 0, 1, 1], 4), CTX)
    lazy = a * b
    assert lazy.is_canonical and lazy.physical_chunks == lazy.chunks == 15
    batch = CiphertextBatch.stack([a, a]) * CiphertextBatch.stack([b, b])
    assert batch.is_canonical and batch.physical_chunks == batch.chunks == 15
    prev = set_eager_order(True)
    try:
        assert set_eager_order(True) is True
        eager = a * b
        assert eager.is_canonical and torch.equal(eager.wt, lazy.wt)
    finally:
        assert set_eager_order(prev) is True
    assert set_eager_order(prev) is prev


@pytest.mark.parametrize("wp", [1024, 4096])
def test_benes_path_takes_any_width(wp):
    """Networks past 64 words route to the lane-group path up to 2048 words
    (n <= 65536) and to the wide path past it; none is refused for its
    size."""
    assert benes_kernels.benes_path(wp) == ("lanes" if wp <= 2048 else "wide")
