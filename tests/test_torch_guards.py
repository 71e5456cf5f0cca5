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

from csgn_tpu_torch import Ciphertext, Context, SecretKey
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import encrypt_kernels, kernels

REPO = pathlib.Path(__file__).resolve().parent.parent
CTX = Context(95, 4)


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300, check=False, **kw)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, csgn_tpu_torch, csgn_tpu_torch.convert, csgn_tpu_torch.ops.dispatch, "
        "csgn_tpu_torch.ops.encrypt_kernels, csgn_tpu_torch.utils; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'csgn_tpu.')) "
        "or m == 'csgn_tpu'); print(bad); sys.exit(1 if bad else 0)"
    )
    res = _run([sys.executable, "-c", code])
    assert res.returncode == 0, res.stdout + res.stderr


def _words(chunks, seed=0):
    rng = np.random.default_rng(seed)
    return words_from_numpy(rng.integers(0, 2**32, (CTX.words32, chunks), dtype=np.uint32))


@pytest.mark.parametrize("fn", ["mul_chunks", "mul_decrypt"])
def test_mul_wrappers_reject_bad_operands(fn):
    a, b = _words(3), _words(4, 1)
    mask = words_from_numpy(CTX.valid_mask)
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
    words, mask = _words(5), words_from_numpy(CTX.valid_mask)
    call = getattr(kernels, fn)
    with pytest.raises(TypeError, match="int32"):
        call(words, mask.to(torch.int64))
    with pytest.raises(ValueError, match="mask"):
        call(words, mask[None])
    with pytest.raises(ValueError, match="device"):
        call(words, mask.to("meta"))


def test_encrypt_wrapper_rejects_bad_operands():
    sk = SecretKey(CTX, [1, 5, 9, 70])
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


def test_decrypt_batch_guards():
    sk = SecretKey(CTX, [1, 5, 9, 70])
    words = sk.encrypt_batch([1, 0, 1, 1, 0, 1], 3)
    assert sk.decrypt_batch(words).tolist() == [1, 0, 1, 1, 0, 1]
    with pytest.raises(ValueError, match="transposed"):
        sk.decrypt_batch(words.t().contiguous())
    with pytest.raises(NotImplementedError):
        sk.decrypt_batch(words[None])
    with pytest.raises(TypeError):
        sk.decrypt_batch(words.numpy())


def test_key_and_ciphertext_guards():
    with pytest.raises(ValueError, match="distinct"):
        SecretKey(CTX, [1, 1, 2, 3])
    with pytest.raises(ValueError, match="range"):
        SecretKey(CTX, [1, 2, 3, 95])
    sk = SecretKey(CTX, [1, 5, 9, 70])
    with pytest.raises(ValueError, match=r"\[W=4, chunks\]"):
        Ciphertext(sk.encrypt_batch([1], 1).t().contiguous(), CTX)
    other = SecretKey(Context(1247, 16), np.arange(16))
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
