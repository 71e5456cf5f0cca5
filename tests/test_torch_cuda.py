"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor csgn_tpu, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)  Equality is
exact: the kernels are integer code.
"""

import numpy as np
import pytest
import torch

from csgn_tpu_torch import Ciphertext, Context, SecretKey
from csgn_tpu_torch.layout import words_from_numpy
from csgn_tpu_torch.ops import encrypt_kernels, kernels

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
    for name in before:
        assert kernels.LAUNCHES[name] == before[name] + 1, name
