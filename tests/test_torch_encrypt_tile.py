"""K7's tile path (csrc/encrypt.cu `philox_tile_kernel`) emulated on the CPU.

The kernel runs only on the card; this emulation follows its schedule
thread by thread: tiles of `PHILOX_TILE_COLS` columns, the group holding
rows W and W + 1 first, the raw rows into the tile, the valid mask from the
first row whose valid word is not all ones, the fix-up over the nonzero
mask rows only (the "other secret bits" test with key[r]'s bit held set,
the bit-1 OR), the patch of the broken word inside the tile, and the row
stores in both forms (16-byte quads, four rows a pass; 4-byte words), with
the tail tile's guards.  Every output word must be written exactly once,
every 16-byte store aligned, and the result equal to
`encrypt_bits_philox_plain`.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from csgn_tpu_torch.layout import bit_positions_to_mask, words_from_numpy
from csgn_tpu_torch.ops import encrypt_kernels as ek

M32 = 0xFFFFFFFF
T = ek.PHILOX_TILE_COLS
ENCRYPT_CU = pathlib.Path(ek.__file__).resolve().parent.parent / "csrc" / "encrypt.cu"


def _philox(cj: torch.Tensor, g: int, k0: int, k1: int) -> list[np.ndarray]:
    return [np.asarray(torch.as_tensor(y).numpy(), dtype=np.uint64).astype(np.uint32)
            for y in ek.philox4x32_10(cj, g, 0, 0, k0, k1)]


def emulate_tile(seed, bits, key_idx, mask, valid, *, col0=0, vec16=True, cols=T):
    """The tile kernel's words uint32 [W, batch], thread by thread."""
    w, d, batch = len(mask), len(key_idx), len(bits)
    k0, k1 = seed & M32, (seed >> 32) & M32
    out = np.zeros(w * batch, dtype=np.uint32)
    writes = np.zeros(w * batch, dtype=np.int64)
    t = np.arange(cols)
    for c0 in range(0, batch, cols):
        j = c0 + t
        live = j < batch
        om = np.where(live & (bits[np.minimum(j, batch - 1)] & 1 == 1), M32, 0).astype(np.uint32)
        cj = torch.from_numpy((col0 + j) & M32)
        ga, la = w // 4, w % 4
        ya = _philox(cj, ga, k0, k1)
        row_w1 = _philox(cj, ga + 1, k0, k1)[0] if la == 3 else ya[la + 1]
        pos = key_idx[ya[la] % np.uint32(d)].astype(np.int64)
        r_word = pos >> 5
        r_bit = (np.uint64(1) << (31 - (pos & 31)).astype(np.uint64)).astype(np.uint32)
        tile = np.zeros((w, cols), dtype=np.uint32)
        for g in range(ga):                   # the rows as they come
            for lane, y in enumerate(_philox(cj, g, k0, k1)):
                tile[4 * g + lane] = y
        for lane in range(la):
            tile[4 * ga + lane] = ya[lane]
        full = next((r for r in range(w) if valid[r] != M32), w)
        for r in range(full, w):
            tile[r] &= valid[r]
        held = tile[r_word, t]
        tile[r_word, t] = held | (r_bit & ~om)
        bad = np.zeros(cols, dtype=np.uint32)
        for r in (r for r in range(w) if mask[r] != 0):     # the compacted nonzero rows
            x = tile[r].copy()
            bad |= np.uint32(mask[r]) & ~x
            tile[r] = x | (np.uint32(mask[r]) & om)
        zero = om == 0
        broken = (held & ~r_bit) | np.where((bad != 0) & ((row_w1 & 1) == 1), r_bit, 0)
        tile[r_word[zero], t[zero]] = broken[zero].astype(np.uint32)

        ncols = min(cols, batch - c0)
        if vec16:
            quads = cols // 4
            for tt in range(cols):
                q = tt % quads
                if 4 * q >= ncols:
                    continue
                for row in range(tt // quads, w, cols // quads):
                    addr = row * batch + c0 + 4 * q
                    assert addr % 4 == 0, "16-byte store not aligned"
                    out[addr:addr + 4] = tile[row, 4 * q:4 * q + 4]
                    writes[addr:addr + 4] += 1
        else:
            for tt in range(ncols):
                addrs = np.arange(w) * batch + c0 + tt
                out[addrs] = tile[:, tt]
                writes[addrs] += 1
    assert np.all(writes == 1), "an output word written other than once"
    return out.reshape(w, batch)


def _operands(w, n, d, seed):
    idx = np.random.default_rng(seed).choice(n, d, replace=False).astype(np.int32)
    mask = bit_positions_to_mask(idx, n)[:w]
    valid = bit_positions_to_mask(np.arange(n), n)[:w]
    return idx, mask, valid


# (W, n): W = 3 straddles rows W and W + 1 over two groups; W = 32 at
# n = 1023 leaves the valid mask's last bit clear, at n = 1024 it is all
# ones; W = 40 is Context(1247, 16); W = 128 is Context(4095, 32)'s width.
@pytest.mark.parametrize("w,n", [(3, 95), (32, 1023), (32, 1024), (40, 1247), (128, 4095)])
@pytest.mark.parametrize("batch", [1, T - 1, T, T + 1, 2 * T + 3, 2 * T + 4])
@pytest.mark.parametrize("col0", [0, 5])
def test_tile_schedule_matches_plain(w, n, batch, col0):
    d = 4 if w == 3 else 16
    idx, mask, valid = _operands(w, n, d, w * 1000 + n)
    bits = np.random.default_rng(batch + col0).integers(0, 2, batch).astype(np.int32)
    seed = (0x5EED << 32) | (batch * 7 + col0)
    want = ek.encrypt_bits_philox_plain(
        seed, torch.from_numpy(bits), torch.from_numpy(idx), words_from_numpy(mask, "cpu"),
        words_from_numpy(valid, "cpu"), col0=col0).numpy().view(np.uint32)
    forms = [False] + ([True] if batch % 4 == 0 else [])   # the 16-byte form needs batch % 4 == 0
    for vec16 in forms:
        got = emulate_tile(seed, bits, idx, mask, valid, col0=col0, vec16=vec16)
        np.testing.assert_array_equal(got, want)


def test_tile_schedule_at_256_columns_a_block():
    """The schedule does not depend on the tile's width (the split tool
    times 256 columns a block)."""
    idx, mask, valid = _operands(40, 1247, 16, 3)
    bits = np.random.default_rng(3).integers(0, 2, 600).astype(np.int32)
    want = emulate_tile(11, bits, idx, mask, valid, vec16=True)
    np.testing.assert_array_equal(emulate_tile(11, bits, idx, mask, valid, cols=256), want)


def test_tile_constants_match_the_source():
    src = ENCRYPT_CU.read_text()
    assert int(re.search(r"constexpr int kTileCols = (\d+);", src).group(1)) == T
    assert (int(re.search(r"constexpr int kTileMaxWords = (\d+);", src).group(1))
            == ek.PHILOX_TILE_MAX_WORDS)
    assert T % 4 == 0
    # The widest tile (words, nonzero mask rows, valid mask) fits a block's
    # 227 KB of shared memory.
    assert ek.PHILOX_TILE_MAX_WORDS * (T + 3) * 4 <= 232448


@pytest.mark.parametrize("w,batch,path", [
    (1, 4, "tile"), (40, 1 << 22, "tile"), (40, 4099, "tile_4byte"), (40, 1, "tile_4byte"),
    (ek.PHILOX_TILE_MAX_WORDS, 8, "tile"), (ek.PHILOX_TILE_MAX_WORDS + 1, 8, "column"),
    (4 * ek.PHILOX_TILE_MAX_WORDS, 7, "column"),
])
def test_philox_path_by_shape(w, batch, path):
    assert ek.philox_path(w, batch) == path


def test_cpu_tensors_never_launch():
    idx, mask, valid = _operands(40, 1247, 16, 4)
    before = dict(ek.LAUNCHES)
    ek.encrypt_bits_philox(5, torch.ones(8, dtype=torch.int32), torch.from_numpy(idx),
                           words_from_numpy(mask, "cpu"), words_from_numpy(valid, "cpu"))
    assert ek.LAUNCHES == before
