"""The plain references against hand-worked values and FIPS-197."""

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import aes128, csgn


def test_mask_words_by_hand():
    # n = 70 -> W = 4; bit j in word j // 32 at shift 31 - j % 32
    m = csgn.mask_words([0, 31, 32, 69], 70).view(np.uint32)
    assert m.tolist() == [0x80000001, 0x80000000, 0x04000000, 0]
    v = csgn.valid_words(70).view(np.uint32)
    assert v.tolist() == [0xFFFFFFFF, 0xFFFFFFFF, 0xFC000000, 0]
    with pytest.raises(ValueError):
        csgn.mask_words([70], 70)


def test_product_and_decrypt_by_hand():
    # two 1-word chunks a side: chunk i * t2 + j = a_i & b_j
    a = torch.tensor([[0b1100, 0b1010]], dtype=torch.int32)
    b = torch.tensor([[0b0110, 0b1111, 0b0001]], dtype=torch.int32)
    prod = csgn.cross_and(a, b)
    assert prod.tolist() == [[0b0100, 0b1100, 0b0000, 0b0010, 0b1010, 0b0000]]
    mask = torch.tensor([0b1000], dtype=torch.int32)
    assert csgn.matches(prod, mask).tolist() == [False, True, False, False, True, False]
    assert csgn.check_product(prod, a, b, mask) == (0, 0)  # two matches: parity 0
    bad = prod.clone()
    bad[0, 3] ^= 1
    assert csgn.check_product(bad, a, b, mask) == (1, 0)
    assert csgn.check_product(None, a, b, torch.tensor([0b1100], dtype=torch.int32))[1] == 1


def test_check_product_blocks(monkeypatch):
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-2**31, 2**31, (4, 37), dtype=torch.int32, generator=g)
    b = torch.randint(-2**31, 2**31, (4, 11), dtype=torch.int32, generator=g)
    mask = torch.tensor([1, 0, 0, 2], dtype=torch.int32)
    whole = csgn.check_product(csgn.cross_and(a, b), a, b, mask)
    monkeypatch.setattr(csgn, "BLOCK_BYTES", 4 * 4 * 11 * 3)  # three rows a block
    assert csgn.check_product(csgn.cross_and(a, b), a, b, mask) == whole == (0, whole[1])


def test_control_product_is_the_swapped_order():
    a = torch.tensor([[1, 2]], dtype=torch.int32)
    b = torch.tensor([[3, 5, 6]], dtype=torch.int32)
    assert csgn.control_product(a, b).tolist() == [[1 & 3, 2 & 3, 1 & 5, 2 & 5, 1 & 6, 2 & 6]]


def test_fresh_chunks_encrypt_their_bits():
    pos = inputs.key_positions(2**40 + 9, 1247, 16)
    gen = inputs.device_generator(5, "t", "cpu")
    bits = torch.randint(0, 2, (3, 500), generator=gen)
    ch = inputs.fresh_chunks(bits, pos, 1247, gen)
    assert ch.shape == (3, 500, 40)
    mask = torch.from_numpy(csgn.mask_words(pos, 1247))
    assert torch.equal(csgn.matches(ch.transpose(-1, -2), mask), bits.bool())
    assert not (ch & ~torch.from_numpy(csgn.valid_words(1247))).any()


def test_streams_split_by_name():
    assert inputs.stream_seed(1, "a") != inputs.stream_seed(1, "b")
    assert inputs.stream_seed(2**62, "a") < 2**63
    assert inputs.key_positions(9, 1247, 16).tolist() == inputs.key_positions(9, 1247, 16).tolist()


def _hex(s):
    return np.frombuffer(bytes.fromhex(s), dtype=np.uint8)[None]


@pytest.mark.parametrize("key, block, out", [
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),                                    # FIPS-197 C.1
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),                                    # Appendix B
])
def test_aes128_fips197(key, block, out):
    assert aes128.encrypt(_hex(key), _hex(block))[0].tobytes().hex() == out


def test_aes128_key_schedule_and_sbox():
    assert aes128.SBOX[0x00] == 0x63 and aes128.SBOX[0x53] == 0xED  # §5.1.1
    rk = aes128.expand_key(_hex("2b7e151628aed2a6abf7158809cf4f3c"))
    assert rk[0, 10].tobytes().hex() == "d014f9a8c9ee2589e13f0cc8b6630ca6"  # A.1, w[40..43]


def test_aes128_reduced_round_differs_and_bits_round_trip():
    rng = np.random.default_rng(4)
    k = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    p = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    full, short = aes128.encrypt(k, p), aes128.encrypt(k, p, rounds=9)
    assert (full != short).any(axis=1).all()
    bits = aes128.to_bits(full)
    assert bits.shape == (64, 128) and bits[0, 8 * 2 + 3] == (full[0, 2] >> 3) & 1
    assert np.array_equal(aes128.from_bits(bits), full)
