#!/usr/bin/env python3
"""Smoke run of csgn_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

With ``--profile`` it also runs phases 4b and 4c three more times warm and
once under `torch.profiler`, and prints each path's host wall, device busy
time, idle share and heaviest kernels as [profile] lines.

Phases, each printing lines tagged [device] / [build] / [check] / [main] /
[rotate] / [circuit] / [entry] / [sharded] / [programs] / [bench] / [order] /
[time]:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA kernels from csgn_tpu_torch/csrc, with the seconds taken,
     and ptxas's registers and spill bytes of every Beneš, fill, Philox
     tile and K14 kernel (a spill there fails the run) and of any other
     kernel that spills;
  3. each kernel against its plain torch version on the card, bit-exact, at
     small and ragged shapes and at the main path's full size: K1-K4, the
     Beneš kernels K8/K9/K12 at n in {20, 100, 1247, 2049, 4095, 8191,
     16383} and up to 2^20 chunks (the register path up to n = 2048, the
     lane-group path above, and the wide kernel forced at n = 1247 against
     the register path), at n in {20000, 40000} on the lane-group path and
     the wide kernel forced, and at n = 70000 on the wide kernel, over 1,000
     and 2^14 chunks (its global-scratch form forced at 20000),
     K1-K3 on batched [B, W, C] operands, the Philox encrypt K7 and its
     stream dump K13 at batches {1, 127, 128, 129, 257, 2^22 - 3, 2^22}, W
     in {3, 32, 40, 128} and one W past K7's tile path, d in {4, 16, 32},
     and W = 32 through Context(1024, 16) (K7 also at col0 = 4099, and on
     each of its paths forced at W in {32, 40, 128}), the JAX package's
     default encrypt engine K14 at W in {3, 32, 40, 128}, d in {4, 16, 32},
     batches {1, 127, 128, 129, 2^22 - 3, 2^22}, each at col0 = 0 and at
     col0 = 4099 of a batch + 4099-column encrypt, and at Context(1247, 16)'s
     key over 2^22 columns, the port's rng against a table of JAX's draws
     (`RNG_VECTORS`), and the write anchor K5 against torch.full;
  4. the main path through the public API at Context(1247, 16), as the JAX
     CLI's demo derives its keys (``split(key(SEED), 4)``): the secret key
     (JAX's indices), two 4096-bit encrypt batches on the default engine
     (K14; their words' sha-256 JAX's) and one on the counter engine (K4),
     decrypt_batch / decrypt, the fused mul_and_decrypt over the 16.7
     M-chunk product, ``*`` and ``+``; every kernel of this path must be
     launched during it;
  4b. the key-rotation path at Context(1247, 16): phase 4's product permuted,
     decrypted under the permuted key, permuted back; then a fleet of 64
     128-chunk ciphertexts, multiplied into [64, 40, 16384], decrypted,
     re-keyed under 64 distinct permutations and decrypted under each
     rotated key; K12, which `permute_and_decrypt` does not use (it stays
     staged, as in the JAX package), is called through its ops-level
     function on the rotated product; every kernel of this path must be
     launched during it;
  4c. the circuit and serving path at Context(1247, 16): a multiplication
     chain (4099 x 37, then x 111, fused with the decrypt), a 1021 x 16411
     product and a 16 x 2^19 product (b beyond L2), each with `*` and
     `mul_and_decrypt`, each product canonical; a `BatchExecutor` (on ``rng.key(SEED)``, its
     flushes on the default engine) fleet of 64 16-bit adders
     (materialized, one group launch) and 256 AES-128 blocks (key-side
     route; request 0 is FIPS-197 C.1), with groups of every other submit_*
     route; the multiply's unaligned and b-streamed modes must be launched
     during it;
  4d. the entry points at Context(1247, 16), each on its default device (the
     card): every `python -m csgn_tpu_torch.cli` command in-process (demo,
     selftest of 2^22 bits, timings at batch 4096, info, flagship), a 2^22-bit
     Philox encrypt decrypted, a fused product of two 4096-bit Philox
     batches, a checkpoint round trip of a 4099 x 37 chain product with its
     key and a permutation through both checkpoint formats, and the encrypt
     statistics (`csgn_tpu_torch.tools.enc_stats`) at Context(4095, 32) over
     2^20 columns; every kernel of this path must be launched during it;
  4e. the sharded path (`csgn_tpu_torch.parallel`) in-process in a job of
     one rank over NCCL, Context(1247, 16): a 4096 x 4096 `sharded_mul_decrypt`
     (parity 1 = chunk_matches) of operands from the key forms of
     `sharded_encrypt_bits` and `sharded_encrypt_bits_invariant` (K14), `sharded_mul_ring` and
     `sharded_mul_allgather` at 4099 x 37 (the unaligned mode), a
     `sharded_permute` of 2^20 chunks, `mul_chain_sharded_decrypt` on 4099 x
     37 x 111, a checkpoint written from the ranks and resumed onto the mesh,
     `parallel.dryrun.run()`, the 2-D ops on a (1, 1) mesh, and one K8 / K9
     / K12 launch at n = 20000 on the Beneš kernel's lane-group path and a
     K8 at n = 70000 on its wide kernel through the public API, against the
     plain versions; every kernel of this path must
     be launched during it; then `sharded_mul_decrypt` in turns with
     `mul_and_decrypt` (the layer's cost with no peer);
  4f. the user programs at Context(1247, 16), each through its main() on
     the default device: the eight examples of `csgn_tpu_torch.examples`
     (voting at 4096 voters, key_rotation at a fleet of 64, sharded_pipeline
     and the scaling report in 4e's job), the validate sweep at its full shapes (every case equal to
     its plain version on the card), the serving demo (32 requests per
     request and in one flush, three trials), the scaling report at world
     size 1, and the fault demo as a subprocess beside the examples (two
     gloo ranks on the CPU, the last killed mid-step, the resume on the
     card); the multiply's
     aligned and unaligned modes, K3, K4, K7, K8 and K9 must be launched
     during it; then 4e's job is destroyed;
  4g. the headline benchmark program, `csgn_tpu_torch.bench.run` in-process
     on the card (the JAX package's bench.py on the port: fused mul+dec,
     mul, dec and the anchor at 4096 x 4096 and 2^24 chunks, the Philox
     encrypt, the Beneš rotation chain, serving and the AES-128 fleet), its
     JSON line printed and held to value > 0, value_vs_anchor <= 1.05,
     enc_suspect false and an AES rate > 0 (the program raises on a wrong
     block); K1, K2, K3, K5, K7 and K8 must be launched during it;
  4h. lazy chunk order at Context(1247, 16) through the public API: two
     4096-bit K14 batches multiplied with `*` and `mul_and_decrypt` on the
     forced j-major route (K1 and K2 on swapped operands), phase 4c's 16 x
     2^19 product on the port's canonical route, `+`, `apply_permutation` (K8), `permute_and_decrypt` and decrypt (K3) of
     the tagged results, a serve flush of tagged requests (mixed tags, one
     shared tag, none) and an io round trip (the sharded save must refuse
     the tagged payload); every canonical() held to the canonical kernel's
     words, every decrypt to the staged parity; then `permute_chunks_mxu`
     (the one-hot bf16 product) against K8 at n = 1247 and 4095; every
     kernel of this path must be launched during it, the reference launches
     of its checks left out of its counts;
  5. timings of each kernel and its plain version at the paths' shapes
     (CUDA events, warm-up, median of distinct inputs; nothing is asserted);
     the multiply's modes also against the aligned mode and today's
     4-byte-store walk, and a sweep of b's size for the streaming threshold;
     K7 against K4 and K7's column path in turns with its tile path (both
     forced), K14 at 40 x 2^22 with its share of the bound, the Beneš kernel K8 in turns with its wide kernel forced
     at n = 1247; the lane-group path's K8 in turns with the wide kernel
     forced at n = 4095 over 2^20 chunks and at n = 20000 and 40000 over
     2^14 chunks, its K12 and K9; the wide kernel
     at n = 70000 over 2^14 chunks in turns with its global-scratch form; the
     batched count form of the multiply's tiled mode at 2 x (16 x 2^19); and
     the write anchor K5 in turns with `Tensor.fill_`, then
     with K1 and with K2 (median per-pair ratio anchor ms / kernel ms, the JAX
     bench's value_vs_anchor); the swapped (j-major) route in turns with the
     tiled mode at 16 x 2^19, as kernels and as the public `*` and
     `mul_and_decrypt` (forced swapped against the port's route), with the tag
     and its canonical() gather alone, and the one-hot permutation against
     K8 at n = 1247 over 2^20 chunks.  Every row gets its bound (the larger of its bytes
     over 3.35 TB/s and its integer operations over 132 SMs x 64 INT32 lanes
     x the SM clock nvidia-smi reports as its maximum) and, where one
     PyTorch call computes the same function, that call's time (library_ms).

Then one JSON line with the kernels, and last the device JSON line.  Any
failure raises and exits non-zero with no result; so does a machine without
a CUDA device.  All data is made from fixed seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import hmac
import itertools
import json
import operator
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from csgn_tpu_torch import (BatchExecutor, Ciphertext, CiphertextBatch, Context, Permutation,
                            RunConfig, SecretKey, bench, cli, models, parallel, set_eager_order)
from csgn_tpu_torch import io as cio
from csgn_tpu_torch import rng as prng
from csgn_tpu_torch.circuit import lift
from csgn_tpu_torch.layout import bit_positions_to_mask, words_from_numpy, words_to_numpy
from csgn_tpu_torch.models import netlist as nl
from csgn_tpu_torch.ops import (_build, benes_kernels, core, dispatch, encrypt_kernels, kernels,
                                order, permute_mxu)
from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.parallel import dryrun
from csgn_tpu_torch.pipeline import (mul_chain, mul_chain_decrypt, mul_chain_sharded,
                                     mul_chain_sharded_decrypt)
from csgn_tpu_torch.examples import (bristol_adder, deep_chain, encrypted_aes, encrypted_hmac,
                                     key_rotation, netlist_service, sharded_pipeline, voting)
from csgn_tpu_torch.tools import enc_stats, scaling_bench, serve_demo, validate
from csgn_tpu_torch.utils.metrics import op_metrics

SEED = 20261016
M32 = 0xFFFFFFFF
MAIN_T = 4096             # bits per encrypt batch on the main path
DEC_CHUNKS = MAIN_T * MAIN_T  # K3 at the product's size: 2^24 chunks, 2.68 GB at W = 40
ENC_BATCH = 1 << 22       # K4 at a large batch
PERM_CHUNKS = 1 << 20     # K8/K12 at the JAX bench's permutation size (bench.py:344)
FLEET, FLEET_T = 64, 128  # rotation fleet: 64 elements of 128 chunks, squared
REPS = 5

# Chain, large-operand and b-beyond-L2 shapes of phase 4c.
CHAIN_T = (4099, 37, 111)         # 151,663 chunks, then 16,834,593 (2.69 GB)
RAGGED_T = (1021, 16411)          # 16,755,631 chunks (2.68 GB)
STREAM_T = (16, 1 << 19)          # b 84 MB, product 1.34 GB
ADDERS, ADDER_BITS = 64, 16       # materialized netlist fleet
AES_FLEET = 256                   # key-side netlist fleet
FIPS197_C1 = ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
              "69c4e0d86a7b0430d8cdb78070b4c55a")

# Phase 3's Philox grid: W = 3 (rows W, W + 1 in two groups), 32 (n = 1023,
# the valid mask's last bit clear; and Context(1024, 16), all ones), 40, 128
# and one past K7's tile path (its column path); batches around the tile's
# width, a full-size batch with batch % 4 != 0 (4-byte row stores) and one
# with batch % 4 == 0 (16-byte row stores); each (W, d) also at col0 != 0,
# and at W in PHILOX_BOTH_WS with each path forced.  Then phase 4d's
# statistics size (the JAX tool's) and scratch directory (gitignored).
PHILOX_TILE = encrypt_kernels.PHILOX_TILE_COLS
PHILOX_WS = (3, 32, 40, 128, encrypt_kernels.PHILOX_TILE_MAX_WORDS + 4)
PHILOX_DS = (4, 16, 32)
PHILOX_BATCHES = (1, PHILOX_TILE - 1, PHILOX_TILE, PHILOX_TILE + 1, 257, ENC_BATCH - 3,
                  ENC_BATCH)
PHILOX_COL0 = 4099
PHILOX_BOTH_WS = (32, 40, 128)
STATS_CTX, STATS_BATCH, STATS_SEED = Context(4095, 32), 1 << 20, 424242
WORKDIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
SHARD_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_sharded"

# The Beneš kernel past 16384 bits: phase 3 at these n (WP = 1024, 2048 on
# the lane-group path, 4096 on the wide kernel), phase 4e at LANES_N and
# WIDE_N, phase 5 at each over WIDE_CHUNKS chunks (the PERF.md rows' size).
WIDE_NS = (20000, 40000, 70000)
LANES_N, WIDE_N, WIDE_CHUNKS = 20000, 70000, 1 << 14
# Phase 4h's small operands (a fresh sum, then three serve operands whose
# j-major product is 37 x 5), its working directory (under build/), the
# one-hot permutation's checks (n, chunks: the bf16 bit matrix is n_pad x
# chunks x 2 bytes) and phase 5's rounds of the public ops.
ORDER_SMALL_T = (3, 37, 5, 11)
ORDER_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_order"
MXU_CHECKS = ((1247, 1 << 18), (4095, 1 << 16))
ORDER_ROUNDS = 3
SHARD_RING_T = (4099, 37)                 # t1 * t2 odd: the multiply's unaligned mode

# Bounds: HBM at the H100 SXM's published
# 3.35 TB/s; integer work at 132 SMs x 64 INT32 lanes x the SM clock.
# Operations are counted per 32-bit lane as the algorithm needs them: a
# threefry2x32 round 3 (add, funnel shift, xor) and a key injection 2, so
# 72 a call; a Philox-4x32 round 4 (two 32x32 -> 64 multiplies, each one
# IMAD.WIDE.U32 giving mul.hi and mul.lo, and two three-input LOP3 xors, as
# the SASS of K7 shows: `csgn_tpu_torch.tools.k7_split --sass`; the key bumps
# are uniform), so 40 a call; the fix-up 3 per word on the column paths (K4),
# and on K7's tile path 4 per nonzero mask row (two for the row's address,
# two LOP3: the test and the bit-1 OR) and 1 per row from the first valid word
# that is not all ones (the rows reach the tile with no work).  A generator call is
# counted once per stream row pair (threefry) or group (Philox), however
# often a kernel evaluates it again.  A Beneš network costs 4 per nonzero
# in-word mask word (two shifts, two three-input LOP3s) and 2 per nonzero
# cross-word pair (one bit-select LOP3 a word) over each stage's live rows of
# the plan timed (`benes_kernels.network_ops`, per plan for K9), per chunk:
# 2,022 on a random plan at n = 1247.  K12 adds one LOP3 per nonzero key
# word (the missed key bits ORed together).
# K14 makes one threefry call a word and three more a column (randint's two
# draws and the coin), with the column paths' fix-up: (W + 3) * 72 + 3 W
# operations a column, 3,216 at W = 40.
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
THREEFRY_OPS, PHILOX_OPS, FIXUP_OPS, TILE_FIXUP_OPS = 72, 40, 3, 4

MUL_CU = "csgn_tpu_torch/csrc/mul.cu"
# One row per Pallas function: (TPU kernel, launch key of the kernel or mode
# that does its job, source, the function it replaces).  K10 and K11a are
# both served by the multiply's unaligned mode; their rows share its launch
# key and are timed at the shapes of their jobs (small t2, large t2).
KERNELS = [
    ("K1", "mul_chunks", MUL_CU, "csgn_tpu/ops/kernels.py:84"),
    ("K2", "mul_decrypt", MUL_CU, "csgn_tpu/ops/kernels.py:158"),
    ("K3", "decrypt_parity", "csgn_tpu_torch/csrc/decrypt.cu", "csgn_tpu/ops/kernels.py:631"),
    ("K3", "chunk_matches", "csgn_tpu_torch/csrc/decrypt.cu", "csgn_tpu/ops/kernels.py:631"),
    ("K4", "encrypt_bits_counter", "csgn_tpu_torch/csrc/encrypt.cu",
     "csgn_tpu/ops/encrypt_pallas.py:250"),
    ("K8", "apply_benes", "csgn_tpu_torch/csrc/benes.cu", "csgn_tpu/ops/permute_benes.py:533"),
    ("K9", "apply_benes_batch", "csgn_tpu_torch/csrc/benes.cu",
     "csgn_tpu/ops/permute_benes.py:399"),
    ("K12", "apply_benes_decrypt", "csgn_tpu_torch/csrc/benes.cu",
     "csgn_tpu/ops/permute_benes.py:307"),
    ("K8l", "benes_lanes", "csgn_tpu_torch/csrc/benes_lanes.cu",
     "csgn_tpu/ops/permute_benes.py:533"),
    ("K8w", "benes_wide", "csgn_tpu_torch/csrc/benes.cu", "csgn_tpu/ops/permute_benes.py:533"),
    ("K6a", "mul_chunks_tiled", MUL_CU, "csgn_tpu/ops/kernels.py:384"),
    ("K6b", "mul_decrypt_tiled", MUL_CU, "csgn_tpu/ops/kernels.py:227"),
    ("K10", "mul_chunks_unaligned", MUL_CU, "csgn_tpu/ops/kernels.py:307"),
    ("K11a", "mul_chunks_unaligned", MUL_CU, "csgn_tpu/ops/kernels.py:444"),
    ("K11b", "mul_decrypt_unaligned", MUL_CU, "csgn_tpu/ops/kernels.py:493"),
    ("K5", "fill_anchor", "csgn_tpu_torch/csrc/fill.cu", "csgn_tpu/ops/kernels.py:581"),
    ("K7", "encrypt_bits_philox", "csgn_tpu_torch/csrc/encrypt.cu",
     "csgn_tpu/ops/encrypt_pallas.py:47"),
    ("K7c", "philox_column", "csgn_tpu_torch/csrc/encrypt.cu", "csgn_tpu/ops/encrypt_pallas.py:47"),
    ("K13", "philox_streams", "csgn_tpu_torch/csrc/encrypt.cu", "tools/enc_stats.py:49"),
    # No pallas_call: the JAX package's default engine, XLA code under jax.jit.
    ("K14", "encrypt_bits_threefry", "csgn_tpu_torch/csrc/encrypt.cu",
     "csgn_tpu/ops/core.py:132"),
]
# The kernels each path must launch (LAUNCHES keys; "_batched" = the same
# kernel on [B, W, C] operands, reported in its kernel's row).
MAIN_PATH = ("mul_chunks", "mul_decrypt", "decrypt_parity", "chunk_matches",
             "encrypt_bits_threefry", "encrypt_bits_counter")
ROTATION_PATH = ("apply_benes", "apply_benes_batch", "apply_benes_decrypt", "decrypt_parity",
                 "mul_chunks_batched", "mul_decrypt_batched", "decrypt_parity_batched",
                 "encrypt_bits_counter")
CIRCUIT_PATH = ("mul_chunks_unaligned", "mul_decrypt_unaligned", "mul_chunks_tiled",
                "mul_decrypt_tiled", "mul_chunks_unaligned_batched",
                "mul_decrypt_unaligned_batched", "decrypt_parity_batched",
                "encrypt_bits_counter", "encrypt_bits_threefry", "apply_benes_batch")
ENTRY_PATH = ("encrypt_bits_threefry", "encrypt_bits_counter", "encrypt_bits_philox", "philox_tile", "philox_streams",
              "fill_anchor", "mul_chunks", "mul_decrypt", "mul_chunks_unaligned", "decrypt_parity",
              "chunk_matches", "apply_benes")
PROGRAMS_PATH = ("mul_chunks", "mul_chunks_unaligned", "mul_decrypt", "mul_decrypt_unaligned",
                 "mul_chunks_batched", "mul_decrypt_batched", "decrypt_parity",
                 "decrypt_parity_batched", "chunk_matches", "encrypt_bits_threefry",
                 "encrypt_bits_philox", "apply_benes", "apply_benes_batch")
SHARDED_PATH = ("mul_chunks", "mul_decrypt", "decrypt_parity", "encrypt_bits_counter",
                "encrypt_bits_threefry",
                "apply_benes", "apply_benes_batch", "apply_benes_decrypt",
                "mul_chunks_unaligned", "mul_decrypt_unaligned", "benes_lanes", "benes_wide",
                "mul_chunks_batched", "decrypt_parity_batched")
BENCH_PATH = ("mul_chunks", "mul_decrypt", "decrypt_parity", "fill_anchor", "encrypt_bits_philox",
              "philox_tile", "encrypt_bits_threefry", "apply_benes")
ORDER_PATH = ("mul_chunks", "mul_decrypt", "mul_chunks_tiled", "mul_decrypt_tiled",
              "decrypt_parity", "decrypt_parity_batched", "apply_benes", "encrypt_bits_threefry",
              "mul_chunks_unaligned_batched", "mul_decrypt_unaligned_batched")

# JAX's draws, from jax.random on the CPU (JAX 0.9.0, partitionable threefry;
# tests/test_torch_jax_random.py holds them to jax.random): phase 3 holds the
# port's rng to RNG_VECTORS (`rng_vectors(SEED)`), and phase 4's secret key
# and its two encrypt batches' words (sha-256, the first 32 hex digits) must
# be what the JAX package draws from jax.random.split(jax.random.key(SEED), 4)
# as its CLI's demo does: the key from keys[0], the batches from keys[1] and
# keys[2] on the default engine.
RNG_VECTORS = {
    "key_data": [0, 20261016],
    "split": [[202623531, 735280029], [3252887076, 734064994], [1821268157, 2867172126]],
    "fold_in_7": [2138856170, 644651993],
    "bits": [[666939830, 3928223558, 3328953251, 990424313],
             [96083914, 2316963648, 2561000205, 1494270259]],
    "randint_16": [12, 11, 9, 4, 2, 14, 10, 5],
    "randint_2p31m1": [1623753116, 115300587, 380645385, 281154532],
    "bernoulli": [1, 0, 1, 1, 1, 1, 1, 1],
    "permutation_16": [1, 3, 2, 6, 0, 5, 14, 11, 9, 8, 4, 12, 7, 15, 10, 13],
    "permutation_1247_head": [295, 1036, 630, 716, 232, 1122, 827, 317, 868, 125, 44, 475],
}
MAIN_KEY_INDICES = [250, 25, 807, 727, 849, 795, 916, 51, 1146, 1193, 203, 414, 366, 997, 141,
                    360]
MAIN_WORDS_SHA256 = ("d8052a3c658141cec08ff496258c894b", "861b8eec60fd8c40a520f7cecc0856b5")
# What the JAX examples draw at their default seeds: voting's yes votes of
# MAIN_T voters, netlist_service's reserve and qualified bids (8 bids of 16
# bits); neither depends on the Context.
VOTING_YES = 3670
AUCTION = (6899, [1, 1, 1, 1, 0, 1, 1, 0])


def rng_vectors(seed: int) -> dict:
    """`RNG_VECTORS`' draws, from the port's rng."""
    k = prng.key(seed)
    data = lambda key: prng.key_data(key).tolist()  # noqa: E731
    return {
        "key_data": data(k),
        "split": [data(x) for x in prng.split(k, 3)],
        "fold_in_7": data(prng.fold_in(k, 7)),
        "bits": prng.bits(k, (2, 4)).tolist(),
        "randint_16": prng.randint(k, (8,), 0, 16).tolist(),
        "randint_2p31m1": prng.randint(k, (4,), 0, 2**31 - 1).tolist(),
        "bernoulli": prng.bernoulli(k, 0.9, (8,)).astype(int).tolist(),
        "permutation_16": prng.permutation(k, 16).tolist(),
        "permutation_1247_head": prng.permutation(k, 1247)[:12].tolist(),
    }


def key_stream(seed: int):
    """Fresh keys ``fold_in(rng.key(seed), i)``, i = 0, 1, ...: the host
    draws of the phases' permutations and Beneš keys."""
    base = prng.key(seed)
    return (prng.fold_in(base, i) for i in itertools.count())


def words_sha256(words: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(words_to_numpy(words)).tobytes()).hexdigest()[:32]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest |x - y| over the uint32 values of two int32 word tensors."""
    require(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
    diff = x != y
    if not bool(diff.any()):
        return 0
    return int(((x[diff].long() & M32) - (y[diff].long() & M32)).abs().max())


def rand_words(ctx: Context, chunks: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Random canonical words [W, chunks] made on the card from `gen`."""
    out = torch.empty((ctx.words32, chunks), dtype=torch.int32, device=dev)
    for r in range(ctx.words32):
        row = torch.randint(0, 1 << 32, (chunks,), dtype=torch.int64, device=dev, generator=gen)
        out[r] = row.to(torch.int32)
    valid = torch.from_numpy(ctx.valid_mask.view(np.int32)).to(dev)
    return out & valid[:, None]


def force(words: torch.Tensor, cols, mask: torch.Tensor) -> torch.Tensor:
    words[..., cols] |= mask[:, None]
    return words


def canon_words(ctx: Context, shape, gen: torch.Generator, dev) -> torch.Tensor:
    """Random canonical words of `shape` [..., W, chunks], made on the card."""
    x = torch.randint(0, 1 << 32, shape, dtype=torch.int64, device=dev, generator=gen)
    valid = torch.from_numpy(ctx.valid_mask.view(np.int32)).to(dev)
    return x.to(torch.int32) & valid[:, None]


# ---------------------------------------------------------------------------
# Phase 3: kernels vs plain, bit-exact
# ---------------------------------------------------------------------------


def check_kernels(ctx, sk, gen, dev, errs: dict) -> None:
    m = sk.mask_words
    saw_parity_one = False
    # 128 x 128 is the JAX package's __graft_entry__.entry() step.
    for t1, t2 in [(1, 1), (3, 5), (13, 7), (9, 33), (128, 128), (128, 130), (MAIN_T, MAIN_T)]:
        a = force(rand_words(ctx, t1, gen, dev), slice(0, t1, 2), m)
        b = force(rand_words(ctx, t2, gen, dev), slice(0, t2, 3), m)
        want = kernels.mul_chunks_plain(a, b)
        e1 = max_abs_err(kernels.mul_chunks(a, b), want)
        prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
        _, parity = kernels.mul_decrypt(a, b, m)
        _, want_count = kernels.mul_decrypt_plain(a, b, m, return_count=True)
        e2 = max(max_abs_err(prod, want), abs(int(count) - int(want_count)),
                 abs(int(parity) - (int(want_count) & 1)))
        errs["mul_chunks"] = max(errs["mul_chunks"], e1)
        errs["mul_decrypt"] = max(errs["mul_decrypt"], e2)
        require(e1 == 0 and e2 == 0, f"K1/K2 disagree with plain at {t1}x{t2}")
        require(int(count) > 0, f"no forced matches counted at {t1}x{t2}")
        saw_parity_one |= int(parity) == 1
        print(f"[check] mul_chunks + mul_decrypt {t1}x{t2}: bit-equal, count {int(count)} "
              f"parity {int(parity)}")
        del a, b, want, prod
    require(saw_parity_one, "no K2 case had parity 1")

    for chunks in [1, 19, 1025, DEC_CHUNKS]:
        words = force(rand_words(ctx, chunks, gen, dev), slice(0, chunks, 7), m)
        e3 = abs(int(kernels.decrypt_parity(words, m))
                 - int(kernels.decrypt_parity_plain(words, m)))
        got = kernels.chunk_matches(words, m)
        e4 = max_abs_err(got, kernels.chunk_matches_plain(words, m))
        errs["decrypt_parity"] = max(errs["decrypt_parity"], e3)
        errs["chunk_matches"] = max(errs["chunk_matches"], e4)
        require(e3 == 0 and e4 == 0, f"K3 disagrees with plain at {chunks} chunks")
        print(f"[check] decrypt_parity + chunk_matches {chunks} chunks: equal, "
              f"{int(got.sum())} matches")
        del words, got

    for batch in [1, 129, ENC_BATCH]:
        bits = torch.randint(0, 2, (batch,), dtype=torch.int32, device=dev, generator=gen)
        args = (bits, *sk.encrypt_operands)
        got = encrypt_kernels.encrypt_bits_counter(SEED + batch, *args)
        e5 = max_abs_err(got, encrypt_kernels.encrypt_bits_counter_plain(SEED + batch, *args))
        errs["encrypt_bits_counter"] = max(errs["encrypt_bits_counter"], e5)
        require(e5 == 0, f"K4 disagrees with plain at batch {batch}")
        require(torch.equal(kernels.chunk_matches(got, m), bits), "encrypt round trip failed")
        require(not bool((got & ~sk.encrypt_operands[2][:, None]).any()), "padding bits set")
        print(f"[check] encrypt_bits_counter batch {batch}: bit-equal, round trip ok, "
              f"padding zero")
        del got, bits


def check_batched(ctx, sk, gen, dev, errs: dict) -> None:
    """K1-K3 on [B, W, C] operands against their plain versions."""
    m = sk.mask_words
    w = ctx.words32
    for batch, t1, t2 in [(1, 3, 5), (7, 13, 7), (FLEET, FLEET_T, FLEET_T)]:
        a = force(canon_words(ctx, (batch, w, t1), gen, dev), slice(0, t1, 2), m)
        b = force(canon_words(ctx, (batch, w, t2), gen, dev), slice(0, t2, 3), m)
        a[1::2] = canon_words(ctx, (batch // 2, w, t1), gen, dev)  # fewer matches there
        want = kernels.mul_chunks_plain(a, b)
        e1 = max_abs_err(kernels.mul_chunks(a, b), want)
        prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
        _, parity = kernels.mul_decrypt(a, b, m)
        _, want_count = kernels.mul_decrypt_plain(a, b, m, return_count=True)
        e2 = max(max_abs_err(prod, want), int((count - want_count).abs().max()),
                 int((parity - (want_count & 1)).abs().max()))
        e3 = int((kernels.decrypt_parity(want, m)
                  - kernels.decrypt_parity_plain(want, m)).abs().max())
        e4 = max_abs_err(kernels.chunk_matches(want, m), kernels.chunk_matches_plain(want, m))
        for name, e in [("mul_chunks", e1), ("mul_decrypt", e2), ("decrypt_parity", e3),
                        ("chunk_matches", e4)]:
            errs[name] = max(errs[name], e)
        require(e1 == e2 == e3 == e4 == 0, f"batched K1-K3 disagree with plain at "
                f"{batch}x({t1}x{t2})")
        require(int(count[0]) > 0, f"no forced matches counted at {batch}x({t1}x{t2})")
        print(f"[check] batched mul_chunks + mul_decrypt + decrypt_parity + chunk_matches "
              f"{batch}x({t1}x{t2}): bit-equal, counts {count[:4].tolist()}...")
        del a, b, want, prod


def _check_mode(name, a, b, m, errs: dict) -> int:
    """One product and count in `name`'s mode against the plain versions;
    returns the count."""
    want = kernels.mul_chunks_plain(a, b)
    e1 = max_abs_err(kernels.mul_chunks(a, b), want)
    prod, count = kernels.mul_decrypt(a, b, m, return_count=True)
    _, parity = kernels.mul_decrypt(a, b, m)
    _, want_count = kernels.mul_decrypt_plain(a, b, m, return_count=True)
    e2 = max(max_abs_err(prod, want), int((count - want_count).abs().max()),
             int((parity - (want_count & 1)).abs().max()))
    errs[f"mul_chunks_{name}"] = max(errs[f"mul_chunks_{name}"], e1)
    errs[f"mul_decrypt_{name}"] = max(errs[f"mul_decrypt_{name}"], e2)
    require(e1 == 0 and e2 == 0, f"{name} mode disagrees with plain at "
            f"{tuple(a.shape)} x {tuple(b.shape)}")
    return int(count.reshape(-1)[0])


def check_modes(ctx, sk, gen, dev, errs: dict) -> None:
    """The multiply's unaligned and b-streamed modes against the plain
    versions, bit-exact: odd t1 with t2 in {1, 3, 37, 1021, 16411}, batches
    of odd elements (at W = 6 their bases leave the 16-byte grid), b past
    the streaming threshold, and phase 4c's full sizes."""
    m = sk.mask_words
    w = ctx.words32
    t_stream = kernels.B_STREAM_BYTES // (4 * w) + 1
    cases = [("unaligned", 4099, 1), ("unaligned", 4099, 3), ("unaligned", 4099, 37),
             ("unaligned", 1021, 1021), ("unaligned", 7, 16411),
             ("unaligned", CHAIN_T[0] * CHAIN_T[1], CHAIN_T[2]), ("unaligned", *RAGGED_T),
             ("tiled", 3, t_stream), ("tiled", *STREAM_T)]
    for mode, t1, t2 in cases:
        require(kernels.mul_mode(w, t1, t2, True) == mode, f"{t1}x{t2} is not {mode}")
        a = force(rand_words(ctx, t1, gen, dev), slice(0, t1, 2), m)
        b = force(rand_words(ctx, t2, gen, dev), slice(0, t2, 3), m)
        before = dict(kernels.LAUNCHES)
        count = _check_mode(mode, a, b, m, errs)
        require(kernels.LAUNCHES[f"mul_decrypt_{mode}"] == before[f"mul_decrypt_{mode}"] + 2,
                f"{t1}x{t2} did not launch the {mode} mode")
        require(count > 0, f"no forced matches counted at {t1}x{t2}")
        print(f"[check] {mode} mode mul_chunks + mul_decrypt {t1}x{t2}: bit-equal, "
              f"count {count}")
        del a, b
    odd = Context(150, 5)                                  # W = 6
    osk = SecretKey(odd, np.arange(5) * 29, device=dev)
    for mode, c, batch, t1, t2 in [("unaligned", ctx, 7, 13, 37), ("unaligned", odd, 5, 3, 7),
                                   ("unaligned", odd, 9, 1, 1021),
                                   ("tiled", ctx, 2, 3, t_stream)]:
        mm = (sk if c is ctx else osk).mask_words
        a = force(canon_words(c, (batch, c.words32, t1), gen, dev), slice(0, t1, 2), mm)
        b = force(canon_words(c, (batch, c.words32, t2), gen, dev), slice(0, t2, 3), mm)
        a[1::2] = canon_words(c, (batch // 2, c.words32, t1), gen, dev)
        require(kernels.mul_mode(c.words32, t1, t2, True) == mode, "batched mode")
        before = kernels.LAUNCHES[f"mul_chunks_{mode}_batched"]
        count = _check_mode(mode, a, b, mm, errs)
        require(kernels.LAUNCHES[f"mul_chunks_{mode}_batched"] == before + 1, "batched launch")
        require(count > 0, "no forced matches counted in element 0")
        print(f"[check] {mode} mode batched {batch}x({t1}x{t2}) at W={c.words32}: "
              f"bit-equal per element")
        del a, b


BENES_NS = (20, 100, 1247, 2049, 4095, 8191, 16383)
BENES_CHUNKS = (1, 129, 1025, PERM_CHUNKS)
FLEET_NS = (20, 100, 1247, 4095)      # K9 also over FLEET plans (routing is slow past them)
# The path forced where phase 3 and phase 5 hold the register and lane-group
# paths against another design (at n = 1247 and n = 4095): the wide kernel,
# which takes any width.
OLD_PATH = "wide"


def _benes_errs(errs: dict, path: str, e: int) -> None:
    """Record a Beneš error under its wrapper rows' key and its path's row."""
    key = {"lanes": "benes_lanes", "wide": "benes_wide", "global": "benes_wide"}.get(path)
    if key:
        errs[key] = max(errs[key], e)


def check_benes(gen, pkeys, dev, errs: dict) -> None:
    """K8 / K12 at every (n, C), K9 at every (n, k, C), against their plain
    versions; K12 with matches forced into every 5th column.  n > 2048 takes
    the lane-group path, the others the register path; at n = 1247 and 2^20
    chunks OLD_PATH is also forced and held to the register path."""
    saw_parity_one = False
    for n in BENES_NS:
        ctx = Context(n, min(16, n // 2))
        sk = SecretKey(ctx, core.keygen(next(pkeys), n, ctx.d).numpy(), device=dev)
        p = Permutation.random(n, next(pkeys))
        plan = p.benes_plan()
        path = benes_kernels.benes_path(plan.words_pad)
        require(path == ("lanes" if n > 2048 else "register"), f"n={n} routed to {path}")
        key = sk.apply_permutation(p).mask_words   # the OUTPUT's key
        # The key's mask permuted back through p^-1 matches `key` after p.
        pre = core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
        for chunks in BENES_CHUNKS:
            x = canon_words(ctx, (ctx.words32, chunks), gen, dev)
            x[:, 0:chunks:5] |= pre
            e8 = max_abs_err(benes_kernels.apply_benes(x, plan),
                             benes_kernels.apply_benes_plain(x, plan))
            out, count = benes_kernels.apply_benes_decrypt(x, plan, key, return_count=True)
            _, parity = benes_kernels.apply_benes_decrypt(x, plan, key)
            want_out, want_count = benes_kernels.apply_benes_decrypt_plain(
                x, plan, key, return_count=True)
            e12 = max(max_abs_err(out, want_out), abs(int(count) - int(want_count)),
                      abs(int(parity) - (int(want_count) & 1)))
            errs["apply_benes"] = max(errs["apply_benes"], e8)
            errs["apply_benes_decrypt"] = max(errs["apply_benes_decrypt"], e12)
            _benes_errs(errs, path, max(e8, e12))
            require(e8 == 0 and e12 == 0, f"K8/K12 disagree with plain at n={n} C={chunks}")
            require(int(count) >= len(range(0, chunks, 5)), f"K12 missed forced matches "
                    f"at n={n} C={chunks}")
            saw_parity_one |= int(parity) == 1
            extra = ""
            if n == 1247 and chunks == PERM_CHUNKS:
                old8, _ = benes_kernels._benes_cuda("apply_benes", x, plan, 0, path=OLD_PATH)
                old12, old_count = benes_kernels._benes_cuda("apply_benes_decrypt", x, plan, 0,
                                                             key, path=OLD_PATH)
                require(torch.equal(old8, out) and torch.equal(old12, out)
                        and int(old_count) == int(count),
                        f"the forced {OLD_PATH} path != the register path at n=1247")
                extra = f"; forced {OLD_PATH} path equal"
                del old8, old12
            print(f"[check] apply_benes + apply_benes_decrypt n={n} ({path} path) C={chunks}: "
                  f"bit-equal, count {int(count)} parity {int(parity)}{extra}")
            del x, out, want_out
        for k in (1, 3, FLEET) if n in FLEET_NS else (1, 3):
            perms = [Permutation.random(n, next(pkeys)) for _ in range(k)]
            stacked = pb.stack_plans([q.benes_plan() for q in perms])
            sizes = (1, 129, 1025) + ((1 << 14,) if k == FLEET else ())
            for chunks in sizes:
                x = canon_words(ctx, (k, ctx.words32, chunks), gen, dev)
                e9 = max_abs_err(benes_kernels.apply_benes_batch(x, stacked),
                                 benes_kernels.apply_benes_batch_plain(x, stacked))
                errs["apply_benes_batch"] = max(errs["apply_benes_batch"], e9)
                _benes_errs(errs, path, e9)
                require(e9 == 0, f"K9 disagrees with plain at n={n} k={k} C={chunks}")
                del x
            print(f"[check] apply_benes_batch n={n} ({path} path) k={k}: bit-equal at C in "
                  f"{sizes}")
    require(saw_parity_one, "no K12 case had parity 1")


def check_benes_wide(gen, pkeys, dev, errs: dict) -> dict:
    """K8 / K12 / K9 past 16384 bits against their plain versions at
    WIDE_NS, over 1,000 (not a multiple of a block's chunks) and WIDE_CHUNKS
    chunks: routed (the lane-group path up to n = 65536, the wide kernel
    above), the wide kernel also forced at the lane-group widths, and its
    global-scratch form forced at LANES_N.  Returns the routed permutations
    by n, for phases 4e and 5."""
    perms = {}
    for n in WIDE_NS:
        ctx = Context(n, 16)
        sk = SecretKey(ctx, core.keygen(next(pkeys), n, ctx.d).numpy(), device=dev)
        t0 = time.perf_counter()
        p, q, r = (Permutation.random(n, next(pkeys)) for _ in range(3))
        plan, stacked = p.benes_plan(), pb.stack_plans([q.benes_plan(), r.benes_plan()])
        route_s = time.perf_counter() - t0
        perms[n] = (p, q, r)
        routed = benes_kernels.benes_path(plan.words_pad)
        require(routed == ("lanes" if n <= 65536 else "wide"), f"n={n} routed to {routed}")
        forms = [routed] + (["wide"] if routed == "lanes" else []) + (
            ["global"] if n == LANES_N else [])
        key = sk.apply_permutation(p).mask_words
        pre = core.permute_chunks(key[:, None], torch.tensor(p.inverse().perm), n)
        for chunks in (1000, WIDE_CHUNKS):
            x = canon_words(ctx, (ctx.words32, chunks), gen, dev)
            x[:, 0:chunks:5] |= pre
            want_out, want_count = benes_kernels.apply_benes_decrypt_plain(x, plan, key,
                                                                           return_count=True)
            xb = canon_words(ctx, (2, ctx.words32, chunks), gen, dev)
            want9 = benes_kernels.apply_benes_batch_plain(xb, stacked)
            for form in forms:
                out8 = benes_kernels._benes_cuda("apply_benes", x, plan, 0, path=form)[0]
                out12, count = benes_kernels._benes_cuda("apply_benes_decrypt", x, plan, 0, key,
                                                         path=form)
                out9 = benes_kernels._benes_cuda(
                    "apply_benes_batch", xb, stacked, len(plan.deltas) * plan.words_pad,
                    path=form)[0]
                e = max(max_abs_err(out8, want_out), max_abs_err(out12, want_out),
                        abs(int(count) - int(want_count)), max_abs_err(out9, want9))
                _benes_errs(errs, form, e)
                require(e == 0, f"{form} path disagrees with plain at n={n} C={chunks}")
            require(int(want_count) >= len(range(0, chunks, 5)), "K12 missed forced matches")
            del x, xb, want_out, want9
        print(f"[check] n={n} (WP={plan.words_pad}, {len(plan.deltas)} stages, routed in "
              f"{route_s:.2f} s): K8, K12 (count {int(want_count)}) and K9 (2 plans) bit-equal "
              f"at C in (1000, {WIDE_CHUNKS}) on the {', '.join(forms)} paths")
    return perms


def philox_operands(w: int, d: int, seed: int, dev, n: int | None = None):
    """Key operands at any W: n = 32 W - 1 bits (or `n`), d random secret
    positions (W = 3 has no Context, W being even there: a raw 3-word mask)."""
    n = 32 * w - 1 if n is None else n
    idx = np.random.default_rng(seed).choice(n, d, replace=False).astype(np.int32)
    mask = bit_positions_to_mask(idx, n)[:w]
    valid = bit_positions_to_mask(np.arange(n), n)[:w]
    return torch.from_numpy(idx).to(dev), words_from_numpy(mask, dev), words_from_numpy(valid, dev)


def check_philox(gen, dev, errs: dict) -> None:
    """K7 and K13 against their plain versions at every (W, d, batch) of the
    grid, and W = 32 through Context(1024, 16); K7 on the path its shape
    takes, at col0 = 0 and PHILOX_COL0, and at PHILOX_BOTH_WS on each path
    forced.  K7 must also equal the fix-up of K13's rows (the stream dump
    consumes exactly K7's draws), round-trip and keep the padding bits
    zero."""
    ctx1024 = Context(1024, 16)
    cases = [(w, d, philox_operands(w, d, w * 100 + d, dev)) for w in PHILOX_WS for d in PHILOX_DS]
    cases.append((ctx1024.words32, ctx1024.d, SecretKey(ctx1024, np.random.default_rng(1024).choice(
        ctx1024.n, ctx1024.d, replace=False), device=dev).encrypt_operands))
    forced_paths = ("tile", "tile_4byte", "column")
    for w, d, ops in cases:
        for batch in PHILOX_BATCHES:
            bits = torch.randint(0, 2, (batch,), dtype=torch.int32, device=dev, generator=gen)
            seed = (SEED << 20) + batch
            got = encrypt_kernels.encrypt_bits_philox(seed, bits, *ops)
            e7 = max_abs_err(got, encrypt_kernels.encrypt_bits_philox_plain(seed, bits, *ops))
            rows = encrypt_kernels.philox_streams(seed, batch, w + 2, dev)
            e13 = max_abs_err(rows, encrypt_kernels.philox_streams_plain(
                seed, batch, w + 2, dev).to(torch.int32))
            at_col0 = encrypt_kernels.encrypt_bits_philox(seed, bits, *ops, col0=PHILOX_COL0)
            e7 = max(e7, max_abs_err(at_col0, encrypt_kernels.encrypt_bits_philox_plain(
                seed, bits, *ops, col0=PHILOX_COL0)))
            by_path = {encrypt_kernels.philox_path(w, batch): e7}
            if w in PHILOX_BOTH_WS and batch in (PHILOX_TILE + 1, ENC_BATCH):
                for path in forced_paths:
                    if path == "tile" and batch % 4:
                        continue                  # 16-byte stores need batch % 4 == 0
                    by_path[path] = max(by_path.get(path, 0), max_abs_err(
                        encrypt_kernels._philox_cuda(seed, bits, *ops, path=path), got))
            e7 = max(by_path.values())
            errs["encrypt_bits_philox"] = max(errs["encrypt_bits_philox"], e7)
            errs["philox_column"] = max(errs["philox_column"], by_path.get("column", 0))
            errs["philox_streams"] = max(errs["philox_streams"], e13)
            require(e7 == 0 and e13 == 0, f"K7/K13 disagree with plain at W={w} d={d} "
                    f"batch={batch}")
            require(torch.equal(encrypt_kernels.derive_words(
                rows.long() & M32, bits, *ops), got), "K7 != fix-up of K13's rows")
            require(torch.equal(kernels.chunk_matches(got, ops[1]), bits),
                    "Philox round trip failed")
            require(not bool((got & ~ops[2][:, None]).any()), "padding bits set")
            del got, rows, bits, at_col0
        path = encrypt_kernels.philox_path(w, ENC_BATCH)
        both = " and each path forced" if w in PHILOX_BOTH_WS else ""
        print(f"[check] encrypt_bits_philox + philox_streams W={w} d={d} batches "
              f"{PHILOX_BATCHES} at col0 0 and {PHILOX_COL0} ({path} path at 2^22{both}): "
              "bit-equal, K7 = fix-up of K13, round trip ok")


THREEFRY_WS = (3, 32, 40, 128)
THREEFRY_BATCHES = (1, PHILOX_TILE - 1, PHILOX_TILE, PHILOX_TILE + 1, ENC_BATCH - 3, ENC_BATCH)
PLAIN_SLICE = 1 << 20     # columns a call of K14's plain version (its int64 temporaries)


def threefry_plain(key, bits, ops, col0: int, total: int) -> torch.Tensor:
    """K14's plain version on the card, `PLAIN_SLICE` columns a call (the
    slices are the whole encrypt's columns, as the plain version's col0 and
    total define them)."""
    return torch.cat([encrypt_kernels.encrypt_bits_threefry_plain(
        key, bits[i:i + PLAIN_SLICE], *ops, col0=col0 + i, total=total)
        for i in range(0, bits.shape[0], PLAIN_SLICE)], dim=1)


def check_threefry(ctx, sk, gen, dev, errs: dict) -> None:
    """The port's rng against JAX's table, then K14 against its plain
    version at every (W, d, batch) of the grid, at col0 = 0 (B = batch) and
    col0 = PHILOX_COL0 (B = batch + PHILOX_COL0), and at Context(1247, 16)'s
    key over 2^22 columns; round trip and padding bits zero."""
    got = rng_vectors(SEED)
    require(got == RNG_VECTORS, f"rng draws differ from JAX's: {got}")
    print(f"[check] rng key/split/fold_in/bits/randint/bernoulli/permutation at key({SEED}): "
          "equal to JAX's table")
    cases = [(w, d, philox_operands(w, d, w * 1000 + d, dev), THREEFRY_BATCHES)
             for w in THREEFRY_WS for d in PHILOX_DS]
    cases.append((ctx.words32, ctx.d, sk.encrypt_operands, (ENC_BATCH,)))
    for w, d, ops, batches in cases:
        for batch in batches:
            bits = torch.randint(0, 2, (batch,), dtype=torch.int32, device=dev, generator=gen)
            key = prng.key((SEED << 24) + batch * 64 + w)
            for col0 in (0, PHILOX_COL0):
                out = encrypt_kernels.encrypt_bits_threefry(key, bits, *ops, col0=col0,
                                                            total=batch + col0)
                e14 = max_abs_err(out, threefry_plain(key, bits, ops, col0, batch + col0))
                errs["encrypt_bits_threefry"] = max(errs["encrypt_bits_threefry"], e14)
                require(e14 == 0, f"K14 disagrees with plain at W={w} d={d} batch={batch} "
                        f"col0={col0}")
                require(torch.equal(kernels.chunk_matches(out, ops[1]), bits),
                        "K14 round trip failed")
                require(not bool((out & ~ops[2][:, None]).any()), "K14 padding bits set")
                del out
            del bits
        print(f"[check] encrypt_bits_threefry W={w} d={d} batches {batches} at col0 0 and "
              f"{PHILOX_COL0}: bit-equal, round trip ok, padding zero")


def check_fill(dev, errs: dict) -> None:
    """K5 against torch.full: the headline product's shape, a C % 4 != 0
    product, and small ragged shapes."""
    for t1, t2, w in [(MAIN_T, MAIN_T, 40), RAGGED_T + (40,), (3, 5, 40), (1, 1, 7)]:
        seed = SEED * 7 + t1
        got = kernels.fill_anchor(seed, t1, t2, w, dev)
        e5 = max_abs_err(got, kernels.fill_anchor_plain(seed, t1, t2, w, dev))
        errs["fill_anchor"] = max(errs["fill_anchor"], e5)
        require(e5 == 0, f"K5 disagrees with torch.full at {t1}x{t2}, W={w}")
        print(f"[check] fill_anchor {t1}x{t2} W={w} (C % 4 = {t1 * t2 % 4}): bit-equal")
        del got


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size, through the public API
# ---------------------------------------------------------------------------


def odd_bits(rng: np.random.Generator, n: int) -> np.ndarray:
    bits = rng.integers(0, 2, n).astype(np.int32)
    if bits.sum() % 2 == 0:
        bits[0] ^= 1
    return bits


def main_path(ctx, keys, rng, dev) -> tuple[dict, Ciphertext]:
    """The JAX CLI demo's flow at full size: ``keys = split(key(SEED), 4)``,
    the secret key from keys[0], two 4096-bit batches on the default engine
    (K14) under keys[1] and keys[2], then decrypts, the fused product, ``*``
    and ``+``; and one counter-engine batch (K4) of the first batch's bits."""
    bits1, bits2 = odd_bits(rng, MAIN_T), odd_bits(rng, MAIN_T)
    xor1, xor2 = int(bits1.sum() % 2), int(bits2.sum() % 2)
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    op_metrics().reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    sk = SecretKey.generate(ctx, keys[0], device=dev)
    c1 = Ciphertext(sk.encrypt_batch(bits1, keys[1]), ctx)
    c2 = Ciphertext(sk.encrypt_batch(bits2, keys[2]), ctx)
    c3 = Ciphertext(sk.encrypt_batch(bits1, SEED + 1), ctx)     # the counter engine
    dec1 = sk.decrypt_batch(c1.wt).cpu().numpy()
    dec2 = sk.decrypt_batch(c2.wt).cpu().numpy()
    dec3 = sk.decrypt_batch(c3.wt).cpu().numpy()
    d1, d2 = int(sk.decrypt(c1)), int(sk.decrypt(c2))
    prod, p = sk.mul_and_decrypt(c1, c2)
    dprod = int(sk.decrypt(prod))
    prod2 = c1 * c2
    same = torch.equal(prod.wt, prod2.wt)
    dsum = int(sk.decrypt(c1 + c2))
    dsum3 = int(sk.decrypt(c1 + c3))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {k: v["calls"] for k, v in op_metrics().snapshot().items()
              if k.startswith(("dispatch.", "mul_chunks.", "mul_decrypt."))}

    require(sk.indices.tolist() == MAIN_KEY_INDICES, f"secret key {sk.indices.tolist()} is not "
            f"JAX's {MAIN_KEY_INDICES}")
    sha = (words_sha256(c1.wt), words_sha256(c2.wt))
    require(sha == MAIN_WORDS_SHA256, f"encrypt words (sha-256 {sha}) are not JAX's "
            f"{MAIN_WORDS_SHA256}")
    require(np.array_equal(dec1, bits1) and np.array_equal(dec2, bits2)
            and np.array_equal(dec3, bits1), "decrypt_batch != encrypted bits")
    require((d1, d2) == (xor1, xor2) == (1, 1), f"decrypt {d1},{d2} != xor {xor1},{xor2}")
    require(int(p) == (xor1 & xor2) == 1, f"mul_and_decrypt parity {int(p)} != 1")
    require(dprod == int(p), "decrypt(prod) != mul_and_decrypt parity")
    require(same, "mul_and_decrypt product != c1 * c2")
    require(dsum == xor1 ^ xor2 and dsum3 == 0, "decrypt(c1 + c2) != xor1 ^ xor2 or "
            "decrypt(c1 + c3) != 0")
    require(tuple(prod.wt.shape) == (ctx.words32, MAIN_T * MAIN_T), "product shape")
    require(max_abs_err(prod.wt, core.mul_chunks(c1.wt, c2.wt)) == 0,
            "product != plain cross-product on the card")
    idle = [k for k in MAIN_PATH if launches[k] == 0]
    require(not idle, f"main path never launched: {idle}")
    require(routes.get("dispatch.mul.cuda") == routes.get("dispatch.mul_dec.cuda") == 1
            and routes.get("mul_chunks.aligned") == routes.get("mul_decrypt.aligned") == 1
            and not any("_jm" in k for k in routes),
            f"the 4096 x 4096 product left the canonical aligned route: {routes}")
    print(f"[main] Context({ctx.n},{ctx.d}) W={ctx.words32}: secret key from "
          f"split(key({SEED}), 4)[0] = JAX's; 2 x {MAIN_T}-bit encrypt on the default engine "
          f"(words = JAX's, sha-256 {sha[0]} {sha[1]}) + 1 on the counter engine, "
          f"product {MAIN_T * MAIN_T} chunks ({prod.nbytes / 1e9:.2f} GB); "
          f"decrypt(c1)={d1} decrypt(c2)={d2} mul_and_decrypt={int(p)} "
          f"decrypt(prod)={dprod} decrypt(c1+c2)={dsum} decrypt(c1+c3)={dsum3}; "
          f"{seconds:.3f} s host wall")
    print(f"[main] routes {json.dumps(routes)}")
    print(f"[main] launches {json.dumps(launches)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    # A small prefix against the CPU path (held to csgn_tpu by the CPU tests):
    # the first 64 columns of the 4096-column encrypt.
    cpu_sk = SecretKey(ctx, sk.indices, device="cpu")
    cpu_c1 = encrypt_kernels.encrypt_bits_threefry(
        keys[1], torch.from_numpy(bits1[:64]), *cpu_sk.encrypt_operands, total=MAIN_T)
    require(np.array_equal(words_to_numpy(c1.wt[:, :64]), words_to_numpy(cpu_c1)),
            "card encrypt != CPU encrypt on the first 64 columns")
    print("[main] first 64 encrypted columns equal the CPU path's")
    return launches, prod


# ---------------------------------------------------------------------------
# Phase 4b: the key-rotation path at full size, through the public API
# ---------------------------------------------------------------------------


def rotation_path(ctx, indices, prod: Ciphertext, p: Permutation, perms: list, rng,
                  dev) -> dict:
    """Phase 4's 2^24-chunk product rotated by `p` and back, then a fleet of
    FLEET ciphertexts grown by `*` and rotated under `perms` (one each)."""
    fleet_bits = rng.integers(0, 2, (FLEET, FLEET_T)).astype(np.int32)
    fleet_bits[0, 0] ^= int(fleet_bits[0].sum() % 2 == 0)   # element 0 decrypts to 1,
    fleet_bits[1, 0] ^= int(fleet_bits[1].sum() % 2 == 1)   # element 1 to 0
    want = fleet_bits.sum(axis=1) % 2
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    # Single: rotate the product, read it under the rotated key, rotate back.
    sk = SecretKey(ctx, indices, device=dev)
    psk = sk.apply_permutation(p)
    rot = prod.apply_permutation(p)
    d_rot = int(psk.decrypt(rot))
    head_ok = torch.equal(rot.wt[:, :4096], core.permute_chunks(
        prod.wt[:, :4096], torch.tensor(p.perm), ctx.n))
    staged, d_staged = sk.permute_and_decrypt(prod, p)
    staged_ok = torch.equal(staged.wt, rot.wt)
    del staged
    # K12 has no API-level caller (permute_and_decrypt is staged, as in the
    # JAX package); its ops-level function is the entry point.
    fused, d_fused = benes_kernels.apply_benes_decrypt(prod.wt, p.benes_plan(), psk.mask_words)
    fused_ok, d_fused = torch.equal(fused, rot.wt), int(d_fused)
    del fused
    back_ok = torch.equal(rot.apply_permutation(p.inverse()).wt, prod.wt)
    del rot

    # Fleet: encrypt, grow with a batched `*`, decrypt, rotate, decrypt.
    batch = CiphertextBatch.stack([
        Ciphertext(sk.encrypt_batch(fleet_bits[i], SEED + 100 + i), ctx) for i in range(FLEET)
    ])
    grown = batch * batch
    dec = sk.decrypt_batch(grown).cpu().numpy()
    fused_prod, fused_bits = sk.mul_and_decrypt_batch(batch, batch)
    fused_prod_ok = torch.equal(fused_prod.wt, grown.wt)
    del fused_prod
    rotated = grown.apply_permutations(perms)
    dec_rot = np.array([int(sk.apply_permutation(perms[i]).decrypt(rotated[i]))
                        for i in range(FLEET)])
    dec_shared = psk.decrypt_batch(grown.apply_permutation(p)).cpu().numpy()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    require(d_rot == 1, f"permuted product decrypts to {d_rot} under the permuted key, not 1")
    require(head_ok, "permuted product != gather oracle on its first 4096 chunks")
    require(staged_ok and fused_ok, "permute_and_decrypt / K12 words != apply_permutation's")
    require(d_staged == d_fused == 1, f"permute_and_decrypt / K12 parity {d_staged}/{d_fused} "
            "!= 1")
    require(back_ok, "p then p.inverse() did not give the product back")
    require(tuple(grown.wt.shape) == (FLEET, ctx.words32, FLEET_T * FLEET_T), "fleet shape")
    require(np.array_equal(dec, want), "fleet decrypt_batch != expected bits")
    require(fused_prod_ok and np.array_equal(fused_bits.cpu().numpy(), want),
            "mul_and_decrypt_batch != batch * batch and expected bits")
    require(np.array_equal(dec_rot, want), "fleet decrypts under the 64 rotated keys != bits")
    require(np.array_equal(dec_shared, want), "shared-permutation fleet decrypt != bits")
    for i in (0, FLEET - 1):
        require(torch.equal(rotated.wt[i], core.permute_chunks(
            grown.wt[i], torch.tensor(perms[i].perm), ctx.n)),
            f"fleet element {i} != gather oracle under its permutation")
    idle = [k for k in ROTATION_PATH if launches[k] == 0]
    require(not idle, f"rotation path never launched: {idle}")
    print(f"[rotate] Context({ctx.n},{ctx.d}): product of {prod.chunks} chunks rotated, "
          f"decrypt under the rotated key {d_rot}, permute_and_decrypt {d_staged}, "
          f"K12 {d_fused}, rotated back bit-equal; fleet {FLEET} x {FLEET_T} chunks -> "
          f"{tuple(grown.wt.shape)} ({grown.nbytes / 1e6:.0f} MB), bits {want.tolist()[:8]}... "
          f"({int(want.sum())} ones) from decrypt_batch, mul_and_decrypt_batch, "
          f"{FLEET} rotated keys and one shared rotation; {seconds:.3f} s host wall")
    print(f"[rotate] launches {json.dumps({k: launches[k] for k in ROTATION_PATH})}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return launches


# ---------------------------------------------------------------------------
# Phase 4c: the circuit and serving path at full size, through the public API
# ---------------------------------------------------------------------------


def _timed(steps: dict, name: str, fn):
    """Run fn() between two synchronizations; record its host wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    steps[name] = time.perf_counter() - t0
    return out


def _columns(words: torch.Tensor, ctx) -> list:
    """Fresh words [W, B] -> B one-chunk Ciphertexts (contiguous views)."""
    cols = words.t().contiguous().unsqueeze(-1)
    return [Ciphertext(cols[k], ctx) for k in range(cols.shape[0])]


def circuit_setup(ctx, pkeys) -> dict:
    """Host set-up of phase 4c: the netlists and the permutations' plans."""
    t0 = time.perf_counter()
    perms = [Permutation.random(ctx, next(pkeys)) for _ in range(8)]
    for q in perms:
        q.benes_plan()
    setup = {"adder": nl.adder(ADDER_BITS), "aes": models.aes128(), "perms": perms}
    print(f"[circuit] set-up: adder({ADDER_BITS}) ({len(setup['adder'].gates)} gates), "
          f"aes128() ({len(setup['aes'].gates)} gates), {len(perms)} Beneš plans in "
          f"{time.perf_counter() - t0:.2f} s")
    return setup


def circuit_path(ctx, indices, setup: dict, rng, dev) -> tuple[dict, dict]:
    """Chains, large and b-beyond-L2 products, and the serving executor's
    netlist fleets; returns (launches, host wall per step)."""
    chain_bits = [odd_bits(rng, t) for t in CHAIN_T]             # each decrypts to 1
    rag_bits = [odd_bits(rng, t) for t in RAGGED_T]               # the product: 1
    str_bits = [rng.integers(0, 2, t).astype(np.int32) for t in STREAM_T]
    str_bits[1][0] ^= int(str_bits[1].sum() % 2)                  # the product: 0
    adder_in = rng.integers(0, 1 << ADDER_BITS, (ADDERS, 2))
    aes_bytes = rng.integers(0, 256, (AES_FLEET, 2, 16)).astype(np.uint8)
    aes_bytes[0] = [np.frombuffer(bytes.fromhex(h), np.uint8) for h in FIPS197_C1[:2]]
    enc_bits = rng.integers(0, 2, 100)
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    steps: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    sk = SecretKey(ctx, indices, device=dev)
    m = sk.mask_words

    def oracle(words):  # parity from the plain per-chunk matches on the card
        return int(core.chunk_matches(words, m).sum() & 1)

    # 1. Multiplication chain: 4099 x 37 unfused, then x 111 fused with the decrypt.
    cts = [Ciphertext(sk.encrypt_batch(b, SEED + 300 + i), ctx) for i, b in enumerate(chain_bits)]
    two = _timed(steps, f"mul_chain {CHAIN_T[0]}x{CHAIN_T[1]}", lambda: mul_chain(cts[:2]))
    d_two = int(sk.decrypt(two))
    three, p_chain = _timed(steps, f"mul_chain_decrypt x{CHAIN_T[2]}", lambda: mul_chain_decrypt(cts, sk))
    require(three.chunks == CHAIN_T[0] * CHAIN_T[1] * CHAIN_T[2], "chain product size")
    require(torch.equal(three.wt, core.mul_chunks(two.wt, cts[2].wt)),
            "chain product != plain product of its steps")
    require(d_two == 1 and int(p_chain) == 1 == oracle(three.wt),
            f"chain parities {d_two}, {int(p_chain)} != 1")
    print(f"[circuit] chain {CHAIN_T[0]} x {CHAIN_T[1]} -> {two.chunks} chunks, decrypt "
          f"{d_two}; x {CHAIN_T[2]} fused with the decrypt -> {three.chunks} chunks "
          f"({three.nbytes / 1e9:.2f} GB), parity {int(p_chain)}")
    del two, three, cts

    # 2. and 3. A large unaligned operand, and b beyond L2: `*` and the fused form.
    for tag, bits, want in (("ragged", rag_bits, 1), ("stream", str_bits, 0)):
        c1, c2 = (Ciphertext(sk.encrypt_batch(b, SEED + 310 + i), ctx) for i, b in enumerate(bits))
        prod = _timed(steps, f"{tag} *", lambda: c1 * c2)
        prod2, p = _timed(steps, f"{tag} mul_and_decrypt", lambda: sk.mul_and_decrypt(c1, c2))
        require(torch.equal(prod.wt, prod2.wt), f"{tag}: * != mul_and_decrypt's product")
        require(int(p) == oracle(prod.wt) == want, f"{tag}: parity {int(p)} != {want}")
        require(prod.is_canonical and prod2.is_canonical, f"{tag}: a product is not canonical")
        print(f"[circuit] {c1.chunks} x {c2.chunks} -> {prod.chunks} chunks "
              f"({prod.nbytes / 1e9:.2f} GB; b {c2.nbytes / 1e6:.0f} MB): `*` and "
              f"mul_and_decrypt bit-equal, parity {int(p)} = the chunk_matches oracle")
        del c1, c2, prod, prod2

    # 4. BatchExecutor, materialized route: 64 16-bit adders in one group.
    ex = BatchExecutor(sk, rng=prng.key(SEED))
    adder = setup["adder"]
    bits = (adder_in[:, :, None] >> np.arange(ADDER_BITS)) & 1          # [64, 2, 16]
    wires = _columns(sk.encrypt_batch(bits.reshape(-1), SEED + 400), ctx)
    w2 = 2 * ADDER_BITS
    futs = [ex.submit_netlist(adder, [wires[r * w2:r * w2 + ADDER_BITS],
                                      wires[r * w2 + ADDER_BITS:(r + 1) * w2]])
            for r in range(ADDERS)]
    g0 = ex.stats["group_dispatches"]
    _timed(steps, "serve adder fleet", ex.flush)
    groups = ex.stats["group_dispatches"] - g0
    outs = [f.result()[0] for f in futs]
    peak = max(ct.chunks for ct in outs[0])
    dec = [[ex.submit_decrypt(ct) for ct in o] for o in outs]
    _timed(steps, "serve decrypt", ex.flush)
    got = np.array([[f.result() for f in row] for row in dec])
    want_bits = np.array([nl.eval_plain(adder, [bits[r, 0], bits[r, 1]])[0]
                          for r in range(ADDERS)])
    sums = (got << np.arange(ADDER_BITS + 1)).sum(axis=1)
    require(groups == 1, f"adder fleet took {groups} group launches, not 1")
    require(np.array_equal(got, want_bits), "adder sums != eval_plain")
    require(np.array_equal(sums, adder_in.sum(axis=1)), "adder sums != a + b")
    print(f"[circuit] BatchExecutor.submit_netlist: {ADDERS} adder({ADDER_BITS}) requests in "
          f"{groups} group launch, peak {peak} chunks per wire "
          f"({ADDERS * ctx.chunk_count_bytes(peak) / 1e9:.2f} GB across the fleet); "
          f"{ADDERS} sums = eval_plain = a + b")
    del outs, futs, dec

    # 5. BatchExecutor, key-side route plus one group of every other route.
    aes = setup["aes"]
    aes_bits = np.array([nl.bits_from_bytes(bytes(k)) + nl.bits_from_bytes(bytes(p))
                         for k, p in aes_bytes])                          # [256, 256]
    wires = _columns(sk.encrypt_batch(aes_bits.reshape(-1), SEED + 500), ctx)
    aes_futs = [ex.submit_netlist_expr(aes, [wires[r * 256:r * 256 + 128],
                                             wires[r * 256 + 128:(r + 1) * 256]])
                for r in range(AES_FLEET)]
    enc_futs = [ex.submit_encrypt(int(b)) for b in enc_bits]
    xa = _columns(sk.encrypt_batch(rng.integers(0, 2, 32 * 3), SEED + 510), ctx)
    xb = _columns(sk.encrypt_batch(rng.integers(0, 2, 32 * 7), SEED + 511), ctx)
    ga = [functools.reduce(operator.add, xa[3 * i:3 * i + 3]) for i in range(32)]  # 3 chunks
    gb = [functools.reduce(operator.add, xb[7 * i:7 * i + 7]) for i in range(32)]  # 7 chunks
    md_futs = [ex.submit_mul_decrypt(x, y) for x, y in zip(ga, gb)]
    pct = Ciphertext(sk.encrypt_batch(rng.integers(0, 2, 129), SEED + 520), ctx)
    perm_futs = [ex.submit_permute(pct, q) for q in setup["perms"]]
    leaf = CiphertextBatch.stack(ga[:8])
    circ = [lift(ga[i]) * gb[i] + ga[i + 1] for i in range(8)] + [lift(leaf) * leaf + ga[0]]
    circ_futs = [ex.submit_decrypt_circuit(e) for e in circ]
    g0 = ex.stats["group_dispatches"]
    _timed(steps, "serve key-side flush", ex.flush)
    groups = ex.stats["group_dispatches"] - g0

    aes_out = [f.result()[0] for f in aes_futs]
    require(nl.bytes_from_bits(aes_out[0]).hex() == FIPS197_C1[2],
            f"AES request 0 {nl.bytes_from_bits(aes_out[0]).hex()} != FIPS-197 C.1")
    for r in (1, 2, 3):
        require(aes_out[r] == nl.eval_plain(aes, [aes_bits[r, :128], aes_bits[r, 128:]])[0],
                f"AES request {r} != eval_plain")
    packed_in = [int.from_bytes(np.packbits(aes_bits[:, j], bitorder="little").tobytes(),
                                "little") for j in range(256)]
    t_fold = time.perf_counter()
    ref = nl.eval_plain_packed(aes, [packed_in[:128], packed_in[128:]], AES_FLEET)[0]
    steps["eval_plain_packed (host, reference)"] = time.perf_counter() - t_fold
    ref_bits = np.array([[(v >> r) & 1 for v in ref] for r in range(AES_FLEET)])
    require(np.array_equal(np.array(aes_out), ref_bits), "AES fleet != eval_plain_packed")
    enc = [f.result() for f in enc_futs]
    require(np.array_equal(sk.decrypt_batch(CiphertextBatch.stack(enc)).cpu().numpy(),
                           enc_bits), "serve encrypts do not decrypt to their bits")
    ex2 = BatchExecutor(sk, rng=prng.key(SEED))
    again = [ex2.submit_encrypt(int(b)) for b in enc_bits]
    require(all(torch.equal(x.wt, y.result().wt) for x, y in zip(enc, again)),
            "serve encrypts are not reproducible from the seed")
    for x, y, f in zip(ga, gb, md_futs):
        prod, bit = f.result()
        require(torch.equal(prod.wt, (x * y).wt) and bit == int(sk.decrypt(x * y)),
                "submit_mul_decrypt != * and decrypt")
    for q, f in zip(setup["perms"], perm_futs):
        require(int(sk.apply_permutation(q).decrypt(f.result())) == int(sk.decrypt(pct)),
                "submit_permute result does not decrypt under the rotated key")
    want_circ = [int(sk.decrypt((ga[i] * gb[i]) + ga[i + 1])) for i in range(8)]
    got_circ = [f.result() for f in circ_futs]
    require(got_circ[:8] == want_circ, "submit_decrypt_circuit != materialized decrypt")
    require(np.array_equal(got_circ[8], sk.decrypt_batch(leaf * leaf + CiphertextBatch.stack(
        [ga[0]] * 8)).cpu().numpy()), "fleet submit_decrypt_circuit != materialized decrypt")
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    idle = [k for k in CIRCUIT_PATH if launches[k] == 0]
    require(not idle, f"circuit path never launched: {idle}")
    print(f"[circuit] BatchExecutor key-side flush: {AES_FLEET} aes128() requests "
          f"(request 0 = FIPS-197 C.1 {FIPS197_C1[2]}; 1-3 = eval_plain; all = "
          f"eval_plain_packed) + {len(enc_bits)} encrypts (decrypt and reproduce) + 32 "
          f"mul_decrypt (3 x 7) + 8 permutes + 9 circuits in {groups} group launches")
    print(f"[circuit] host wall per step (s): {json.dumps(steps)}; whole phase "
          f"{seconds:.3f} s with its checks")
    print(f"[circuit] launches {json.dumps({k: launches[k] for k in CIRCUIT_PATH})}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return launches, steps


# ---------------------------------------------------------------------------
# Phase 4d: the entry points, each on its default device
# ---------------------------------------------------------------------------


def entry_path(ctx, indices, rng, pkeys) -> tuple[dict, dict]:
    """The CLI's commands in-process, the Philox engine through the key, a
    checkpoint round trip in both formats, and the encrypt statistics; no
    device is named anywhere, so each lands on the current CUDA device.
    Returns (launches, host wall per step)."""
    shutil.rmtree(WORKDIR, ignore_errors=True)
    WORKDIR.mkdir(parents=True)
    small = ["--n", str(ctx.n), "--d", str(ctx.d), "--seed", str(SEED)]
    configs = {}
    for name, batch in (("selftest", ENC_BATCH), ("timings", MAIN_T)):
        configs[name] = WORKDIR / f"{name}.json"
        configs[name].write_text(RunConfig(ctx.n, ctx.d, SEED, batch).to_json())
    commands = [["demo", *small], ["selftest", "--config", str(configs["selftest"])],
                ["timings", "--config", str(configs["timings"])], ["info", *small],
                ["flagship", *small]]
    enc_bits = rng.integers(0, 2, ENC_BATCH).astype(np.int32)
    mul_bits = [odd_bits(rng, MAIN_T), odd_bits(rng, MAIN_T)]
    chain_bits = [odd_bits(rng, t) for t in CHAIN_T[:2]]
    perm = Permutation.random(ctx, next(pkeys))
    perm.benes_plan()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    steps: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    for argv in commands:
        print(f"[entry] python -m csgn_tpu_torch.cli {' '.join(argv)}")
        rc = _timed(steps, f"cli {argv[0]}", lambda: cli.main(argv))
        require(rc == 0, f"cli {argv[0]} returned {rc}")

    sk = SecretKey(ctx, indices)                     # the default device
    require(sk.device.type == "cuda", f"SecretKey defaulted to {sk.device}")
    words = _timed(steps, f"encrypt_batch philox {ENC_BATCH}",
                   lambda: sk.encrypt_batch(enc_bits, SEED + 600, engine="philox"))
    dec = sk.decrypt_batch(words).cpu().numpy()
    require(np.array_equal(dec, enc_bits), "Philox round trip != bits")
    del words
    c1, c2 = (Ciphertext(sk.encrypt_batch(b, SEED + 610 + i, engine="philox"), ctx)
              for i, b in enumerate(mul_bits))
    prod, parity = _timed(steps, f"mul_and_decrypt philox {MAIN_T}x{MAIN_T}",
                          lambda: sk.mul_and_decrypt(c1, c2))
    staged = int(core.chunk_matches(prod.wt, sk.mask_words).sum() & 1)
    require(int(parity) == staged == 1, f"Philox mul_and_decrypt parity {int(parity)}, "
            f"staged oracle {staged}, expected 1")
    del prod, c1, c2

    cts = [Ciphertext(sk.encrypt_batch(b, SEED + 620 + i), ctx) for i, b in enumerate(chain_bits)]
    chain = mul_chain(cts)
    want = (int(sk.decrypt(chain)), int(sk.apply_permutation(perm).decrypt(
        chain.apply_permutation(perm))))
    objects = {"chain": chain, "sk": sk, "perm": perm}
    _timed(steps, "save_state", lambda: cio.save_state(WORKDIR / "state.npz", objects))
    state = _timed(steps, "load_state", lambda: cio.load_state(WORKDIR / "state.npz"))
    _timed(steps, "save_state_sharded",
           lambda: cio.save_state_sharded(WORKDIR / "sharded", objects))
    sharded = _timed(steps, "load_state_sharded",
                     lambda: cio.load_state_sharded(WORKDIR / "sharded"))
    for tag, st in (("load_state", state), ("load_state_sharded", sharded)):
        require(st["chain"].wt.is_cuda and st["sk"].device.type == "cuda",
                f"{tag} did not load onto the card")
        require(torch.equal(st["chain"].wt, chain.wt), f"{tag}: chain words differ")
        require(np.array_equal(st["sk"].indices, sk.indices) and st["perm"] == perm,
                f"{tag}: key or permutation differs")
        got = (int(st["sk"].decrypt(st["chain"])), int(st["sk"].apply_permutation(
            st["perm"]).decrypt(st["chain"].apply_permutation(st["perm"]))))
        require(got == want == (1, 1), f"{tag}: decrypts {got} != {want}")
    chunks, mb = chain.chunks, chain.nbytes / 1e6
    del chain, cts, state, sharded

    stats = _timed(steps, "enc_stats", lambda: enc_stats.run(STATS_CTX, STATS_BATCH, STATS_SEED))
    require(stats["ok"], f"enc_stats failed: {stats['failed']}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    idle = [k for k in ENTRY_PATH if launches[k] == 0]
    require(not idle, f"entry path never launched: {idle}")
    print(f"[entry] cli demo, selftest ({ENC_BATCH} bits), timings (batch {MAIN_T}), info, "
          f"flagship: rc 0; Philox {ENC_BATCH}-bit round trip ok; Philox {MAIN_T}x{MAIN_T} "
          f"mul_and_decrypt parity {int(parity)} = staged oracle; checkpoint of a {CHAIN_T[0]}x{CHAIN_T[1]} chain ({chunks} chunks, "
          f"{mb:.1f} MB) + key + permutation through save_state/load_state and "
          f"save_state_sharded/load_state_sharded: bit-equal, decrypts {want}")
    print("[entry] enc_stats " + json.dumps({k: v for k, v in stats.items() if k != "hist"}))
    print(f"[entry] host wall per step (s): {json.dumps(steps)}; whole phase {seconds:.3f} s")
    print(f"[entry] launches {json.dumps({k: launches[k] for k in ENTRY_PATH})}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    shutil.rmtree(WORKDIR, ignore_errors=True)
    return launches, {"steps": steps, "seconds": seconds, "enc_stats": stats}


# ---------------------------------------------------------------------------
# Phase 4e: the sharded path at world size 1, over NCCL
# ---------------------------------------------------------------------------


def sharded_path(ctx, indices, rng, pkeys, wide_perms, card: str, dev) -> tuple[dict, dict]:
    """`csgn_tpu_torch.parallel` in-process at world size 1 over NCCL, in the
    job `main` opened on `dev` (a ``file://`` store in the gitignored build
    directory, SHARD_DIR): the headline fused
    product sharded, the ring and all-gather products in the unaligned mode,
    a sharded permutation of 2^20 chunks, the sharded chain fused with the
    decrypt, a checkpoint written from the ranks and resumed onto the mesh,
    the dry run, the 2-D ops on a (1, 1) mesh, and one K8 / K9 / K12 launch
    at n = LANES_N on the Beneš kernel's lane-group path and a K8 at n =
    WIDE_N on its wide kernel through the public API.  Returns (launches,
    timings)."""
    bits1, bits2 = odd_bits(rng, MAIN_T), odd_bits(rng, MAIN_T)
    ring_bits = [odd_bits(rng, t) for t in SHARD_RING_T]
    chain_bits = [odd_bits(rng, t) for t in CHAIN_T]
    fleet_bits = rng.integers(0, 2, (FLEET, FLEET_T)).astype(np.int32)
    fleet_bits[0, 0] ^= int(fleet_bits[0].sum() % 2 == 0)        # element 0 decrypts to 1
    wctx, bctx = Context(LANES_N, 16), Context(WIDE_N, 16)
    wide_bits, big_bits = odd_bits(rng, WIDE_CHUNKS), odd_bits(rng, 1000)
    wp, wq, wr = wide_perms[LANES_N]
    bp = wide_perms[WIDE_N][0]
    perm = Permutation.random(ctx, next(pkeys))
    perm.benes_plan()
    require(torch.distributed.get_backend() == "nccl", "the process group is not NCCL")
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    steps: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    mesh = parallel.global_chunk_mesh()
    require(mesh.device == dev and mesh.shape == {"c": 1}, f"mesh {mesh}")
    sk = SecretKey(ctx, indices)
    m = sk.mask_words
    ops = sk.encrypt_operands

    # The headline: a 4096 x 4096 fused product, sharded; its operands from
    # the key forms of both sharded encrypts (K14): the per-rank stream
    # fold_in(key, rank) and the mesh-invariant one.
    k1, k2 = prng.key(SEED + 800), prng.key(SEED + 801)
    c1 = parallel.sharded_encrypt_bits(k1, torch.from_numpy(bits1).to(dev), *ops, ctx.n, ctx.d,
                                       mesh)
    c2 = parallel.sharded_encrypt_bits_invariant(k2, torch.from_numpy(bits2).to(dev), *ops,
                                                 ctx.n, ctx.d, mesh)
    enc_ok = (torch.equal(c1, sk.encrypt_batch(bits1, prng.fold_in(k1, 0)))
              and torch.equal(c2, sk.encrypt_batch(bits2, k2)))
    prod, parity = _timed(steps, f"sharded_mul_decrypt {MAIN_T}x{MAIN_T}",
                          lambda: parallel.sharded_mul_decrypt(c1, c2, m, mesh))
    oracle = int(core.chunk_matches(prod, m).sum() & 1)
    require(enc_ok, "sharded encrypt != the one-device encrypt")
    require(int(parity) == oracle == 1, f"sharded_mul_decrypt parity {int(parity)}, "
            f"chunk_matches {oracle}, expected 1")
    require(tuple(prod.shape) == (ctx.words32, MAIN_T * MAIN_T), "headline product shape")
    head = prod[:, :1 << 20].contiguous()                   # 2^20 chunks for the permute
    del prod

    # Ring and all-gather in the unaligned mode.
    a, b = (sk.encrypt_batch(x, SEED + 810 + i) for i, x in enumerate(ring_bits))
    ring = _timed(steps, "sharded_mul_ring", lambda: parallel.sharded_mul_ring(a, b, mesh))
    gath = _timed(steps, "sharded_mul_allgather",
                  lambda: parallel.sharded_mul_allgather(a, b, mesh))
    require(torch.equal(ring, gath) and torch.equal(ring, kernels.mul_chunks_plain(a, b)),
            "ring / all-gather != the plain product")
    del ring, gath

    # A sharded permutation of 2^20 chunks, decrypted under the permuted key.
    psk = sk.apply_permutation(perm)
    rot = _timed(steps, "sharded_permute 2^20",
                 lambda: parallel.sharded_permute(head, perm.benes_plan(), mesh))
    d_head = int(parallel.sharded_decrypt_parity(head, m, mesh))
    d_rot = int(parallel.sharded_decrypt_parity(rot, psk.mask_words, mesh))
    require(d_rot == d_head, f"permuted block decrypts to {d_rot}, not {d_head}")
    require(torch.equal(rot[:, :4096], core.permute_chunks(
        head[:, :4096], torch.tensor(perm.perm), ctx.n)), "sharded permute != gather oracle")
    del rot

    # The sharded chain, fused with the decrypt: 4099 x 37 x 111.
    cts = [Ciphertext(sk.encrypt_batch(x, SEED + 820 + i), ctx)
           for i, x in enumerate(chain_bits)]
    chain, p_chain = _timed(steps, "mul_chain_sharded_decrypt",
                            lambda: mul_chain_sharded_decrypt(cts, sk, mesh))
    two = mul_chain_sharded(cts[:2], mesh)
    require(int(p_chain) == 1 == int(core.chunk_matches(chain.wt, m).sum() & 1),
            f"sharded chain parity {int(p_chain)} != 1")
    require(torch.equal(chain.wt, kernels.mul_chunks_plain(two.wt, cts[2].wt)),
            "sharded chain != the plain product of its steps")
    del chain

    # Checkpoint from the ranks, resumed onto the mesh.
    _timed(steps, "save_state_sharded (mesh)", lambda: cio.save_state_sharded(
        SHARD_DIR / "ckpt", {"two": two, "sk": sk, "perm": perm}, mesh))
    back = _timed(steps, "load_state_sharded (mesh)",
                  lambda: cio.load_state_sharded(SHARD_DIR / "ckpt", mesh=mesh))
    require(torch.equal(back["two"].wt, two.wt) and back["two"].wt.is_cuda
            and back["perm"] == perm, "checkpoint round trip differs")
    require(int(back["sk"].decrypt(back["two"])) == 1, "resumed chain does not decrypt to 1")
    del two, back, cts

    # The dry run, and the 2-D ops on a (1, 1) mesh.
    summary = _timed(steps, "dryrun.run", lambda: dryrun.run(workdir=SHARD_DIR))
    mesh2 = parallel.batch_chunk_mesh(1, 1)
    fleet = torch.stack([sk.encrypt_batch(fleet_bits[i], SEED + 830 + i)
                         for i in range(FLEET)])                      # [64, 40, 128]
    blk = parallel.shard_batch(fleet, mesh2)
    grown = parallel.sharded_mul_batch(blk, blk, mesh2)
    dec = parallel.sharded_decrypt_batch(grown, m, mesh2).cpu().numpy()
    rot_b = parallel.sharded_permute_batch(grown, perm.benes_plan(), mesh2)
    dec_rot = psk.decrypt_batch(rot_b).cpu().numpy()
    want = fleet_bits.sum(axis=1) % 2
    require(np.array_equal(dec, want) and np.array_equal(dec_rot, want),
            "2-D sharded fleet decrypts != bits")
    require(torch.equal(grown, kernels.mul_chunks_plain(fleet, fleet)), "2-D product")
    del fleet, blk, grown, rot_b

    # The Beneš kernel's lane-group path at n = LANES_N and its wide
    # kernel at n = WIDE_N, through the public API.
    wsk = SecretKey(wctx, core.keygen(next(pkeys), LANES_N, 16).numpy())
    wct = Ciphertext(wsk.encrypt_batch(wide_bits, SEED + 840), wctx)
    wrot = wct.apply_permutation(wp)
    d_wide = int(wsk.apply_permutation(wp).decrypt(wrot))
    wfleet = CiphertextBatch.stack([wct, wct])
    wrot2 = wfleet.apply_permutations([wq, wr])
    wfused, wcount = benes_kernels.apply_benes_decrypt(
        wct.wt, wp.benes_plan(), wsk.apply_permutation(wp).mask_words, return_count=True)
    bsk = SecretKey(bctx, core.keygen(next(pkeys), WIDE_N, 16).numpy())
    bct = Ciphertext(bsk.encrypt_batch(big_bits, SEED + 841), bctx)
    brot = bct.apply_permutation(bp)
    d_big = int(bsk.apply_permutation(bp).decrypt(brot))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # Held against the plain versions (not counted: the path's run is over).
    e = max(max_abs_err(wrot.wt, benes_kernels.apply_benes_plain(wct.wt, wp.benes_plan())),
            max_abs_err(wrot2.wt, benes_kernels.apply_benes_batch_plain(
                wfleet.wt, pb.stack_plans([wq.benes_plan(), wr.benes_plan()]))),
            max_abs_err(wfused, wrot.wt),
            max_abs_err(brot.wt, benes_kernels.apply_benes_plain(bct.wt, bp.benes_plan())))
    _, want_count = benes_kernels.apply_benes_decrypt_plain(
        wct.wt, wp.benes_plan(), wsk.apply_permutation(wp).mask_words, return_count=True)
    require(e == 0 and int(wcount) == int(want_count),
            f"lane-group path at n={LANES_N} or wide kernel at n={WIDE_N} != plain")
    require(d_wide == d_big == 1 and int(wcount) & 1 == 1,
            f"rotations decrypt to {d_wide} (n={LANES_N}) and {d_big} (n={WIDE_N})")
    idle = [k for k in SHARDED_PATH if launches[k] == 0]
    require(not idle, f"sharded path never launched: {idle}")

    # The layer's cost with no peer: sharded_mul_decrypt against
    # mul_and_decrypt on the same operands, in turns.
    pairs = [tuple(sk.encrypt_batch(odd_bits(rng, MAIN_T), SEED + 850 + 2 * k + i)
                   for i in range(2)) for k in range(REPS)]
    cpairs = [(Ciphertext(x, ctx), Ciphertext(y, ctx)) for x, y in pairs]
    sh_ms, md_ms = time_pair(
        lambda k: parallel.sharded_mul_decrypt(*pairs[k], m, mesh),
        lambda k: sk.mul_and_decrypt(*cpairs[k]), [(k,) for k in range(REPS)])
    del pairs, cpairs
    print(f"[sharded] world size 1 over NCCL ({mesh}): {MAIN_T}x{MAIN_T} sharded_mul_decrypt "
          f"parity {int(parity)} = chunk_matches; ring = all-gather = plain at "
          f"{SHARD_RING_T[0]}x{SHARD_RING_T[1]}; sharded_permute of 2^20 chunks decrypts "
          f"{d_rot} under the permuted key; mul_chain_sharded_decrypt "
          f"{'x'.join(map(str, CHAIN_T))} parity {int(p_chain)}; checkpoint resumed onto the "
          f"mesh; dryrun {json.dumps(summary)}; (1, 1) mesh fleet {FLEET} x {FLEET_T}^2 decrypts "
          f"= bits; n={LANES_N} lane-group path K8/K9/K12 and n={WIDE_N} wide kernel K8 "
          f"bit-equal to plain, rotated decrypts {d_wide}, {d_big}; {seconds:.3f} s host wall")
    print(f"[sharded] sharded_mul_decrypt {sh_ms:.4f} ms against mul_and_decrypt {md_ms:.4f} ms "
          f"in turns ({MAIN_T}x{MAIN_T}, overhead {sh_ms - md_ms:+.4f} ms); {card}")
    print(f"[sharded] host wall per step (s): {json.dumps(steps)}")
    print(f"[sharded] launches {json.dumps({k: launches[k] for k in SHARDED_PATH})}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, {"sharded_ms": sh_ms, "mul_and_decrypt_ms": md_ms, "steps": steps}


# ---------------------------------------------------------------------------
# Phase 4f: the user programs, each through its main()
# ---------------------------------------------------------------------------


def programs_path(card: str) -> tuple[dict, dict]:
    """The eight examples at Context(1247, 16) (voting at MAIN_T voters,
    key_rotation at a fleet of FLEET, sharded_pipeline in the job of one
    rank that `main` opened for phases 4e and 4f), the validate sweep at its
    full shapes, the serving demo, the scaling report at world size 1, and
    the fault demo as a subprocess (two gloo ranks on the CPU, the resume on
    the card).  The fault demo, most of it process start-up, runs beside the
    examples and the sweep, and is waited for before the two timed programs
    (serve_demo, scaling_bench).  Each example checks its own decrypts; this
    phase also holds their results that the JAX examples fix (the CPU tests
    hold every key of them to the JAX examples').  Returns (launches,
    results)."""
    n, d = 1247, 16
    root = pathlib.Path(__file__).resolve().parent
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    steps: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    fault = subprocess.Popen(
        [sys.executable, "-m", "csgn_tpu_torch.tools.fault_demo", "--nproc", "2"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = {
            "voting": _timed(steps, "voting", lambda: voting.main(voters=MAIN_T, n=n, d=d)),
            "deep_chain": _timed(steps, "deep_chain", lambda: deep_chain.main(n=n, d=d)),
            "key_rotation": _timed(steps, "key_rotation",
                                   lambda: key_rotation.main(fleet=FLEET, n=n, d=d)),
            "bristol_adder": _timed(steps, "bristol_adder",
                                    lambda: bristol_adder.main(n=n, d=d)),
            "netlist_service": _timed(steps, "netlist_service",
                                      lambda: netlist_service.main(n=n, d=d)),
            "encrypted_aes": _timed(steps, "encrypted_aes",
                                    lambda: encrypted_aes.main(n=n, d=d)),
            "encrypted_hmac": _timed(steps, "encrypted_hmac",
                                     lambda: encrypted_hmac.main(n=n, d=d)),
            "sharded_pipeline": _timed(steps, "sharded_pipeline",
                                       lambda: sharded_pipeline.main(n=n, d=d)),
        }
        rc = _timed(steps, "validate", validate.main)
        require(rc == 0, "validate found cases that differ from the plain versions")
        fault_out, fault_err = _timed(steps, "fault_demo wait",
                                      lambda: fault.communicate(timeout=300))
        steps["fault_demo"] = time.perf_counter() - t0
        serve = _timed(steps, "serve_demo", serve_demo.main)
        scaling = _timed(steps, "scaling_bench", lambda: scaling_bench.run(nproc=1))
    finally:
        if fault.poll() is None:
            fault.kill()
            fault.wait()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    print(fault_out.strip())
    require(fault.returncode == 0 and "fault demo: OK" in fault_out
            and "killed worker 1 of 2" in fault_out
            and "on 1 rank (cuda:0): words_exact=True" in fault_out,
            f"fault demo failed (rc {fault.returncode}): {fault_err[-3000:]}")
    v, dc, kr = out["voting"], out["deep_chain"], out["key_rotation"]
    require(v["voters"] == MAIN_T and v["parity"] == v["yes_votes"] % 2
            and v["unanimous"] == int(v["yes_votes"] == MAIN_T), f"voting {v}")
    require((dc["depth"], dc["final_chunks"], dc["peak_chunks"], dc["recrypts"],
             dc["unbounded_chunks_would_be"], dc["decrypted"]) == (16, 16, 4096, 1, 1 << 16, 1),
            f"deep_chain {dc}")
    require(kr["fleet"] == FLEET and kr["decrypted"] == kr["expected"], f"key_rotation {kr}")
    require(out["bristol_adder"]["sum"] == 123456789 + 987654321, "bristol_adder sum")
    ns = out["netlist_service"]
    require(ns["encrypt_dispatches"] == 1 and (ns["reserve"], ns["qualified"]) == AUCTION,
            f"netlist_service {ns}: launches, or not the JAX example's auction {AUCTION}")
    require(v["yes_votes"] == VOTING_YES, f"voting drew {v['yes_votes']} yes votes, the JAX "
            f"example {VOTING_YES}")
    require(out["encrypted_aes"]["ciphertext"] == FIPS197_C1[2], "encrypted_aes block")
    require(out["encrypted_hmac"]["tag"] == hmac.new(bytes(range(32)), b"attested by csgn_tpu",
                                                     "sha256").hexdigest(), "encrypted_hmac tag")
    sp = out["sharded_pipeline"]
    require(sp == {"devices": 1, "batch": 64, "product_chunks": 64 * 64, "parity": 0},
            f"sharded_pipeline {sp}")
    idle = [k for k in PROGRAMS_PATH if launches[k] == 0]
    require(not idle, f"programs path never launched: {idle}")

    print(f"[programs] Context({n},{d}): voting {MAIN_T} voters ({v['yes_votes']} yes, parity "
          f"{v['parity']}, unanimous {v['unanimous']}); deep_chain {dc}; key_rotation fleet "
          f"{FLEET} decrypts = bits; adder64 sum, netlist_service (one encrypt launch), AES-128 "
          f"= FIPS-197 C.1, HMAC-SHA-256 = hmac; sharded_pipeline {sp}; validate FAILS: none; "
          f"fault demo OK; {seconds:.3f} s host wall")
    for i, t in enumerate(serve["trials"]):
        print(f"[programs] serve_demo trial {i}: {serve['requests']} mul_decrypt requests "
              f"per-request {t['per_request_ms']:.3f} ms, batched {t['batched_ms']:.3f} ms, "
              f"speedup {t['speedup']:.3f}; {card}")
    print(f"[programs] scaling_bench {json.dumps(scaling)}; {card}")
    print(f"[programs] AES-128 {json.dumps(out['encrypted_aes'])}; HMAC "
          f"{json.dumps(out['encrypted_hmac'])}")
    print(f"[programs] host wall per step (s): {json.dumps(steps)}; whole phase {seconds:.3f} s")
    print(f"[programs] launches {json.dumps({k: launches[k] for k in PROGRAMS_PATH})}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, {"steps": steps, "seconds": seconds, "serve": serve, "scaling": scaling}


# ---------------------------------------------------------------------------
# Phase 4g: the headline benchmark program
# ---------------------------------------------------------------------------


def bench_path(card: str) -> tuple[dict, dict]:
    """`csgn_tpu_torch.bench.run` on the card, in-process.  Its JSON line is
    held to what a right run can read: value > 0, value_vs_anchor <= 1.05 (no
    product is written faster than the fill of its shape), enc_suspect false
    and an AES fleet rate > 0 (the program raises on a wrong block).
    Returns (launches, the line)."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    line = bench.run(torch.device("cuda", 0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    print(f"[bench] {json.dumps(line)}")
    require(line["value"] > 0, f"bench value {line['value']}")
    require(line["value_vs_anchor"] <= 1.05,
            f"bench value_vs_anchor {line['value_vs_anchor']} > 1.05: faster than the fill")
    require(not line["enc_suspect"], "bench enc row above the card's write bound")
    require(line["aes_fleet_blocks_per_s"] > 0, "bench AES fleet rate")
    idle = [k for k in BENCH_PATH if launches[k] == 0]
    require(not idle, f"bench path never launched: {idle}")
    print(f"[bench] {seconds:.3f} s host wall; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")
    return launches, line


# ---------------------------------------------------------------------------
# Phase 4h: lazy chunk order, through the public API
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def forced_jmajor():
    """Every `*`, `mul_and_decrypt` and batched form inside takes the
    j-major route (the canonical kernel on the swapped operands), whatever
    the card's rule picks, as tests/test_torch_order.py forces it."""
    saved = {name: getattr(dispatch, name) for name in (
        "mul_chunks_auto", "mul_decrypt_auto", "mul_chunks_batched", "mul_decrypt_batched_auto")}

    def mul(a, b):
        return dispatch.mul_chunks_jmajor(a, b), True, 0, 0

    def mul_dec(a, b, m):
        out, parity = kernels.mul_decrypt(b, a, m)
        return out, True, 0, 0, parity

    for name, fn in (("mul_chunks_auto", mul), ("mul_decrypt_auto", mul_dec),
                     ("mul_chunks_batched", mul), ("mul_decrypt_batched_auto", mul_dec)):
        setattr(dispatch, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dispatch, name, fn)


@contextlib.contextmanager
def uncounted():
    """The launches inside (a check's reference calls) are left out of the
    path's counts."""
    saved = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        kernels.LAUNCHES.update(saved)


def order_path(ctx, indices, rng, pkeys, gen, dev) -> tuple[dict, dict]:
    """Tagged (lazy-order) ciphertexts through the public API at Context(1247,
    16): two 4096-bit K14 batches multiplied on the forced j-major route
    (K1 and K2 on swapped operands), phase 4c's 16 x 2^19 product on the
    port's canonical route, `+`, `apply_permutation` (K8),
    `permute_and_decrypt` and decrypt (K3) of the tagged results, a serve
    flush of tagged requests (mixed, shared and no tags) and an io round
    trip; every canonical() against the canonical kernel's words, every
    decrypt against the staged parity.  Then `permute_chunks_mxu` against K8
    at n = 1247 and 4095.  The checks' reference launches are not counted
    (`uncounted`).  Returns (launches, host wall per step)."""
    keys = prng.split(prng.key(SEED + 800), 8)
    a_bits, b_bits = odd_bits(rng, MAIN_T), odd_bits(rng, MAIN_T)
    s_bits = [odd_bits(rng, t) for t in STREAM_T]
    small_bits = [odd_bits(rng, t) for t in ORDER_SMALL_T]
    perm = Permutation.random(ctx, next(pkeys))
    perm.benes_plan()                                  # host routing is set-up
    mxu = []
    for n, chunks in MXU_CHECKS:
        mctx = Context(n, 16)
        q = Permutation.random(mctx, next(pkeys))
        q.benes_plan()
        mxu.append((mctx, q, chunks))
    shutil.rmtree(ORDER_DIR, ignore_errors=True)
    ORDER_DIR.mkdir(parents=True)
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    steps: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    sk = SecretKey(ctx, indices, device=dev)
    m = sk.mask_words
    # 1. 4096-bit batches on the default engine, multiplied on the forced
    #    j-major route: the product's words are K1's on (b, a).
    a = Ciphertext(sk.encrypt_batch(a_bits, keys[0]), ctx)
    b = Ciphertext(sk.encrypt_batch(b_bits, keys[1]), ctx)
    with forced_jmajor():
        jm = _timed(steps, "forced j-major *", lambda: a * b)
        jm2, p_jm = _timed(steps, "forced j-major mul_and_decrypt",
                           lambda: sk.mul_and_decrypt(a, b))
    with uncounted():
        canon = kernels.mul_chunks(a.wt, b.wt)
    require(not jm.is_canonical and jm.pad == 0 and jm.chunks == MAIN_T * MAIN_T,
            "forced j-major product is not tagged")
    require(torch.equal(jm.wt, jm2.wt) and torch.equal(jm.logical, jm2.logical),
            "forced j-major: * != mul_and_decrypt's product")
    lazy_canon = _timed(steps, f"canonical() {MAIN_T}x{MAIN_T}", lambda: jm.canonical().wt)
    require(torch.equal(lazy_canon, canon), "j-major product's canonical() != K1's words")
    d_jm = int(sk.decrypt(jm))
    require(int(p_jm) == d_jm == 1, f"j-major parities {int(p_jm)}, {d_jm} != 1")
    del jm2, canon, lazy_canon

    # 2. Phase 4c's 16 x 2^19 product (b streams) on the port's canonical
    #    route, `*` and fused; then tagged as a JAX TPU product crosses
    #    (j-major, from the swapped operands).
    c1, c2 = (Ciphertext(sk.encrypt_batch(bits, keys[2 + i]), ctx) for i, bits in enumerate(s_bits))
    big = _timed(steps, f"{STREAM_T[0]}x{STREAM_T[1]} *", lambda: c1 * c2)
    big2, p_big = _timed(steps, f"{STREAM_T[0]}x{STREAM_T[1]} mul_and_decrypt",
                         lambda: sk.mul_and_decrypt(c1, c2))
    with uncounted():
        canon_big, p_canon = kernels.mul_decrypt(c1.wt, c2.wt, m)    # the canonical kernel
    require(big.is_canonical and big2.is_canonical, "16 x 2^19 product is not canonical")
    require(torch.equal(big.wt, big2.wt) and torch.equal(big.wt, canon_big),
            "16 x 2^19: * or mul_and_decrypt != the canonical kernel's words")
    require(int(p_big) == int(p_canon) == 1, f"16 x 2^19 parity {int(p_big)}, {int(p_canon)}")
    with forced_jmajor():
        big = _timed(steps, f"{STREAM_T[0]}x{STREAM_T[1]} * (forced j-major)", lambda: c1 * c2)
    require(not big.is_canonical and torch.equal(big.canonical().wt, canon_big),
            "16 x 2^19 j-major: canonical() != the canonical kernel's words")
    del big2

    # 3. `+`, apply_permutation (K8), permute_and_decrypt and decrypt (K3)
    #    of the tagged results.
    tiny = Ciphertext(sk.encrypt_batch(small_bits[0], keys[4]), ctx)
    s = jm + tiny
    require(not s.is_canonical and torch.equal(
        s.canonical().wt, torch.cat([jm.canonical().wt, tiny.wt], dim=1)), "tagged + != concat")
    require(int(sk.decrypt(s)) == 0, "decrypt(tagged + fresh) != 1 ^ 1")
    del s, jm
    q = _timed(steps, "apply_permutation (tagged)", lambda: big.apply_permutation(perm))
    require(q.logical is big.logical, "apply_permutation dropped the tag")
    with uncounted():
        want_q = dispatch.permute(canon_big, perm.benes_plan())
    require(torch.equal(q.canonical().wt, want_q),
            "permuted tagged product's canonical() != K8 on the canonical words")
    psk = sk.apply_permutation(perm)
    require(int(psk.decrypt(q)) == 1, "permuted tagged product does not decrypt under the "
            "rotated key")
    q2, p_q = sk.permute_and_decrypt(big, perm)
    require(q2.logical is big.logical and torch.equal(q2.wt, q.wt) and int(p_q) == 1,
            "permute_and_decrypt of a tagged product")
    del q, q2, canon_big, want_q

    # 4. A serve flush of tagged requests: mixed tags, one shared tag (a
    #    batch's elements) and none.
    x = [Ciphertext(sk.encrypt_batch(bits, keys[5 + i]), ctx)
         for i, bits in enumerate(small_bits[1:])]
    with forced_jmajor():
        lazy = x[0] * x[1]
        shared = CiphertextBatch.stack([x[0], x[0]]) * CiphertextBatch.stack([x[1], x[1]])
    ex = BatchExecutor(sk, rng=prng.key(SEED))
    reqs = [(lazy, x[2]), (lazy.canonical(), x[2]), (shared[0], x[1]), (shared[1], x[1]),
            (x[2], x[0]), (x[2], x[0])]
    futs = [(ex.submit_mul(u, v), ex.submit_mul_decrypt(u, v), ex.submit_decrypt(u), u, v)
            for u, v in reqs]
    g0 = ex.stats["group_dispatches"]
    _timed(steps, "serve flush (tagged)", ex.flush)
    groups = ex.stats["group_dispatches"] - g0
    for fm, fmd, fd, u, v in futs:
        prod, bit = fmd.result()
        with uncounted():
            want = kernels.mul_chunks(u.canonical().wt, v.canonical().wt)
            staged = int(kernels.decrypt_parity(want, m)), int(sk.decrypt(u))
        require(torch.equal(fm.result().canonical().wt, want)
                and torch.equal(prod.canonical().wt, want), "serve product != canonical kernel")
        require((bit, fd.result()) == staged, "serve decrypts != the staged parity")

    # 5. Serialization: the tagged product's bytes under lazy and eager
    #    order, an io round trip of it, and the sharded save refusing it.
    prev = set_eager_order(True)
    try:
        with forced_jmajor():
            eager = x[0] * x[1]
    finally:
        set_eager_order(prev)
    require(eager.is_canonical and not lazy.is_canonical
            and np.array_equal(eager.to_u64(), lazy.to_u64()), "to_u64() lazy != eager")
    path = ORDER_DIR / "lazy.npz"
    _timed(steps, "save_ciphertext (tagged)", lambda: cio.save_ciphertext(path, lazy))
    back = cio.load_ciphertext(path)
    require(back.is_canonical and np.array_equal(back.to_u64(), lazy.to_u64())
            and torch.equal(back.wt, lazy.canonical().wt), "io round trip of a tagged product")
    try:
        cio.save_state_sharded(ORDER_DIR / "sharded", {"ct": lazy})
        require(False, "sharded save took a lazy payload")
    except ValueError as e:
        require("canonical payload" in str(e), f"sharded save refused with {e}")

    # 6. The one-hot permutation against K8.
    mxu_out = []
    for mctx, q, chunks in mxu:
        words = rand_words(mctx, chunks, gen, dev)
        onehot = permute_mxu.onehot_matrix(q.perm, mctx.n, dev)
        got = _timed(steps, f"permute_chunks_mxu n={mctx.n}",
                     lambda: permute_mxu.permute_chunks_mxu(words, onehot, mctx.n))
        with uncounted():
            want = benes_kernels.apply_benes(words, q.benes_plan())
        require(torch.equal(got, want), f"permute_chunks_mxu != K8 at n = {mctx.n}")
        mxu_out.append(f"n={mctx.n} over {chunks} chunks")
        del words, got, want
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shutil.rmtree(ORDER_DIR, ignore_errors=True)
    idle = [k for k in ORDER_PATH if launches[k] == 0]
    require(not idle, f"order path never launched: {idle}")
    print(f"[order] Context({ctx.n},{ctx.d}): forced j-major {MAIN_T} x {MAIN_T} `*` and "
          f"mul_and_decrypt (K1, K2 on swapped operands), canonical() = K1's words, parity "
          f"{int(p_jm)}; {STREAM_T[0]} x {STREAM_T[1]} canonical = the canonical kernel's "
          f"words, parity {int(p_big)}, its forced j-major canonical() = them too; + / apply_permutation / permute_and_decrypt / decrypt of tagged "
          f"results; serve flush of {len(reqs)} x 3 tagged requests in {groups} group launches; "
          f"to_u64() lazy = eager; io round trip (the sharded save refuses it); permute_chunks_mxu = K8 at "
          f"{', '.join(mxu_out)}")
    print(f"[order] host wall per step (s): {json.dumps(steps)}; whole phase {seconds:.3f} s")
    print(f"[order] launches {json.dumps({k: launches[k] for k in ORDER_PATH})}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return launches, steps


def profile_path(label: str, run, warm: int) -> None:
    """A path `warm` times warm (host wall), then once under torch.profiler:
    device busy time (the union of kernel intervals), idle share of the host
    wall, and the heaviest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kern):
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    by_name: dict = {}
    for k in kern:
        n_us = by_name.setdefault(k.name[:60], [0, 0.0])
        n_us[0] += 1
        n_us[1] += k.time_range.end - k.time_range.start
    print(f"[profile] {label} path host wall, {warm} warm runs: "
          f"{[round(w * 1e3, 3) for w in walls]} ms")
    print(f"[profile] {label} " + json.dumps({
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_us / 1e3,
        "idle_share_of_wall": 1 - busy_us / 1e3 / wall_ms, "kernel_launches": len(kern)}))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"[profile] {label} {us / 1e3:9.3f} ms  x{n:4d}  {name}")


# ---------------------------------------------------------------------------
# Phase 5: timings
# ---------------------------------------------------------------------------


def time_turns(kernel_fn, plain_fn, inputs) -> tuple[list, list]:
    """ms of kernel and plain on each of the distinct inputs, in turns
    (plain, kernel, kernel, plain, ...), after one warm-up of each."""
    kernel_fn(*inputs[0])
    plain_fn(*inputs[0])
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for i, args in enumerate(inputs):
        order = [("plain", plain_fn), ("kernel", kernel_fn)]
        for name, fn in order if i % 2 == 0 else order[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times["kernel"], times["plain"]


def run_ms(fn, inputs) -> float:
    """ms per call of one run of `fn` over the distinct inputs, launched back
    to back after one untimed call, so that the tail of whatever ran before
    stays outside the window and launches queue behind each other."""
    fn(*inputs[-1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in inputs:
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(inputs)


def time_pair(kernel_fn, plain_fn, inputs) -> tuple[float, float]:
    """ms per call of kernel and plain: the mean of two runs of each over the
    distinct inputs, in turns (plain, kernel, kernel, plain)."""
    p0, k0, k1, p1 = (run_ms(f, inputs) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k0 + k1) / 2, (p0 + p1) / 2


class Bounds:
    """The least time the card could take for a function: the larger of its
    bytes (each input read once, each output written once) over HBM's rate
    and its integer operations over the INT32 peak at `sm_mhz`."""

    def __init__(self, sm_mhz: float):
        self.sm_mhz = sm_mhz
        self.int_ops_per_s = SMS * INT32_LANES * sm_mhz * 1e6

    def __call__(self, nbytes: float, ops: float = 0.0) -> dict:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.int_ops_per_s * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": int(nbytes), "bound_ops": int(ops)}


def mul_bytes(w: int, t1: int, t2: int, batch: int = 1) -> int:
    """A product's operands read and output written."""
    return 4 * batch * w * (t1 + t2 + t1 * t2)


def encrypt_ops(w: int, batch: int, engine: str, mask=None, valid=None) -> int:
    """Integer operations of an encrypt of W = `w` words (or, with engine
    "dump", of K13 over `w` rows) per the counts above: W + 2 stream rows
    (K14: W words and three draws a column).
    The Philox engine's fix-up counts the nonzero rows of `mask` and the
    rows of `valid` (uint32 numpy words) from its first that is not all
    ones."""
    if engine == "counter":       # one threefry call per pair of rows
        return batch * ((w + 3) // 2 * THREEFRY_OPS + FIXUP_OPS * w)
    if engine == "threefry":      # K14: one threefry call per word, three more a column
        return batch * ((w + 3) * THREEFRY_OPS + FIXUP_OPS * w)
    if engine == "philox":        # one Philox call per group of four rows
        partial = np.flatnonzero(valid != M32)
        masked = w - (int(partial[0]) if partial.size else w)
        return batch * (-(-(w + 2) // 4) * PHILOX_OPS
                        + TILE_FIXUP_OPS * int(np.count_nonzero(mask)) + masked)
    return batch * -(-w // 4) * PHILOX_OPS


def library_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes the product (library_ms only)."""
    return torch.bitwise_and(a[:, :, None], b[:, None, :])


def timings(ctx, sk, gen, dev, card: str, p: Permutation, stacked, bound) -> dict:
    m = sk.mask_words
    w = ctx.words32
    nz = int((m != 0).sum())          # the mask's nonzero rows: all K3 must read
    out = {}

    def report(name, shape, nbytes, ms, plain_ms, extra="", batched=False, bnd=None,
               library_ms=None):
        entry = {"shape": shape, "ms": ms, "plain_ms": plain_ms}
        if bnd is not None:
            entry.update(bnd, library_ms=library_ms)
        if batched:
            out[name]["batched"] = entry
        else:
            out[name] = entry
        tag = f"{name} (batched)" if batched else name
        more = ""
        if bnd is not None:
            more = f"; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})"
            if library_ms is not None:
                more += f", library {library_ms:.4f} ms"
        print(f"[time] {tag} {shape}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
              f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s){extra}{more}; "
              f"{card}")

    # Distinct inputs are distinct real ciphertexts: a fresh chunk of bit 1
    # matches the mask, so about a quarter of each product's chunks match,
    # as on the main path.
    def fresh_batch(seed):
        bits = torch.randint(0, 2, (MAIN_T,), dtype=torch.int32, device=dev, generator=gen)
        return sk.encrypt_batch(bits, seed)

    ab = [(fresh_batch(SEED + 10 * k), fresh_batch(SEED + 10 * k + 1)) for k in range(REPS)]
    prod_bytes = w * MAIN_T * MAIN_T * 4
    shape = f"{MAIN_T}x{MAIN_T}"
    ms, pms = time_pair(lambda x, y: kernels.mul_decrypt(x, y, m),
                        lambda x, y: kernels.mul_decrypt_plain(x, y, m), ab)
    report("mul_decrypt", shape, prod_bytes, ms, pms,
           f", {MAIN_T * MAIN_T / ms / 1e3:.1f} M chunk-ops/s fused",
           bnd=bound(mul_bytes(w, MAIN_T, MAIN_T) + 4 * w + 8))
    ms, pms = time_pair(kernels.mul_chunks, kernels.mul_chunks_plain, ab)
    lib_ms, _ = time_pair(library_and, kernels.mul_chunks, ab)
    report("mul_chunks", shape, prod_bytes, ms, pms, bnd=bound(mul_bytes(w, MAIN_T, MAIN_T)),
           library_ms=lib_ms)

    # K5, the write anchor: against torch.full and Tensor.fill_, then in
    # turns with K1 and with K2 on the same distinct inputs; value_vs_anchor
    # is the median over pairs of anchor ms / kernel ms (bench.py:280-286).
    def anchor(*_):
        return kernels.fill_anchor(SEED, MAIN_T, MAIN_T, w, dev)

    seeds = [(SEED + k,) for k in range(REPS)]
    ms, pms = time_pair(lambda s: kernels.fill_anchor(s, MAIN_T, MAIN_T, w, dev),
                        lambda s: kernels.fill_anchor_plain(s, MAIN_T, MAIN_T, w, dev), seeds)
    buf = torch.empty((w, MAIN_T * MAIN_T), dtype=torch.int32, device=dev)
    lib_ms, k5_ms = time_pair(lambda s: buf.fill_(s & 0x7FFFFFFF),
                              lambda s: kernels.fill_anchor(s, MAIN_T, MAIN_T, w, dev), seeds)
    del buf
    ratios = {}
    for name, fn in (("mul_chunks", kernels.mul_chunks),
                     ("mul_decrypt", lambda x, y: kernels.mul_decrypt(x, y, m))):
        k_ms, a_ms = time_turns(fn, anchor, ab)
        ratios[name] = {"value_vs_anchor": statistics.median(
            a / k for a, k in zip(a_ms, k_ms)), "kernel_ms": k_ms, "anchor_ms": a_ms}
    report("fill_anchor", shape, prod_bytes, ms, pms,
           f"; in turns with Tensor.fill_: {k5_ms:.4f} ms against {lib_ms:.4f} ms; anchor / K1 "
           f"{ratios['mul_chunks']['value_vs_anchor']:.3f}, anchor / K2 "
           f"{ratios['mul_decrypt']['value_vs_anchor']:.3f} (median per pair)",
           bnd=bound(prod_bytes), library_ms=lib_ms)
    out["fill_anchor"].update(against_library_ms=k5_ms, value_vs_anchor=ratios)

    prods = [(kernels.mul_chunks(x, y),) for x, y in ab]      # DEC_CHUNKS chunks each
    del ab
    ms, pms = time_pair(lambda x: kernels.decrypt_parity(x, m),
                        lambda x: kernels.decrypt_parity_plain(x, m), prods)
    report("decrypt_parity", f"{w}x{DEC_CHUNKS}", w * DEC_CHUNKS * 4, ms, pms,
           f" (bytes counted over all W rows; the kernel reads the mask's {nz} rows only)",
           bnd=bound(4 * nz * DEC_CHUNKS + 4 * w + 8))
    del prods

    bits = torch.randint(0, 2, (ENC_BATCH,), dtype=torch.int32, device=dev, generator=gen)
    args = (bits, *sk.encrypt_operands)
    seeds = [(SEED + k,) for k in range(1, REPS + 1)]
    enc_bytes = 4 * (w + 1) * ENC_BATCH
    ms, pms = time_pair(lambda s: encrypt_kernels.encrypt_bits_counter(s, *args),
                        lambda s: encrypt_kernels.encrypt_bits_counter_plain(s, *args), seeds)
    report("encrypt_bits_counter", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, ms, pms,
           f", {ENC_BATCH / ms / 1e3:.1f} M enc/s",
           bnd=bound(enc_bytes, encrypt_ops(w, ENC_BATCH, "counter")))
    ms, pms = time_pair(lambda s: encrypt_kernels.encrypt_bits_philox(s, *args),
                        lambda s: encrypt_kernels.encrypt_bits_philox_plain(s, *args), seeds)
    k7_ms, k4_ms = time_pair(lambda s: encrypt_kernels.encrypt_bits_philox(s, *args),
                             lambda s: encrypt_kernels.encrypt_bits_counter(s, *args), seeds)
    k7_bound = bound(enc_bytes, encrypt_ops(w, ENC_BATCH, "philox", words_to_numpy(m),
                                            ctx.valid_mask))
    report("encrypt_bits_philox", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, ms, pms,
           f", {ENC_BATCH / ms / 1e3:.1f} M enc/s, share {k7_bound['bound_ms'] / ms:.3f} of "
           f"the bound on the {encrypt_kernels.philox_path(w, ENC_BATCH)} path; in turns with "
           f"K4: K7 {k7_ms:.4f} ms, K4 {k4_ms:.4f} ms", bnd=k7_bound)
    out["encrypt_bits_philox"]["against_counter"] = {"philox_ms": k7_ms, "counter_ms": k4_ms}
    col_ms, tile_ms = time_pair(
        lambda s: encrypt_kernels._philox_cuda(s, *args, path="column"),
        lambda s: encrypt_kernels._philox_cuda(s, *args, path="tile"), seeds)
    report("philox_column", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, col_ms, pms,
           f" (K7's column path forced; in turns with the tile path forced: {tile_ms:.4f} ms)",
           bnd=k7_bound)
    out["philox_column"]["against_tile_ms"] = tile_ms
    # K14, the JAX package's default engine, under distinct keys.
    keys = [(prng.key(SEED + k),) for k in range(1, REPS + 1)]
    ms, pms = time_pair(lambda k: encrypt_kernels.encrypt_bits_threefry(k, *args),
                        lambda k: encrypt_kernels.encrypt_bits_threefry_plain(k, *args), keys)
    k14_bound = bound(enc_bytes, encrypt_ops(w, ENC_BATCH, "threefry"))
    report("encrypt_bits_threefry", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, ms, pms,
           f", {ENC_BATCH / ms / 1e3:.1f} M enc/s, share {k14_bound['bound_ms'] / ms:.3f} of "
           "the bound", bnd=k14_bound)
    fresh = [(encrypt_kernels.encrypt_bits_counter(s, *args),) for (s,) in seeds]
    ms, pms = time_pair(lambda x: kernels.chunk_matches(x, m),
                        lambda x: kernels.chunk_matches_plain(x, m), fresh)
    report("chunk_matches", f"{w}x{ENC_BATCH}", w * ENC_BATCH * 4, ms, pms,
           bnd=bound(4 * nz * ENC_BATCH + 4 * ENC_BATCH + 4 * w))
    del fresh, bits, args

    # K13 at the statistics' size: W + 2 = 130 rows of 2^20 columns.
    rows = STATS_CTX.words32 + 2
    ms, pms = time_pair(
        lambda s: encrypt_kernels.philox_streams(s, STATS_BATCH, rows, dev),
        lambda s: encrypt_kernels.philox_streams_plain(s, STATS_BATCH, rows, dev), seeds)
    report("philox_streams", f"{rows}x{STATS_BATCH}", 4 * rows * STATS_BATCH, ms, pms,
           bnd=bound(4 * rows * STATS_BATCH, encrypt_ops(rows, STATS_BATCH, "dump")))

    # Batched K1-K3 at the fleet's shapes: 64 x (128 x 128), real ciphertexts.
    def fleet(seed):
        bits = torch.randint(0, 2, (FLEET * FLEET_T,), dtype=torch.int32, device=dev,
                             generator=gen)
        words = sk.encrypt_batch(bits, seed)            # [W, FLEET * FLEET_T]
        return words.reshape(w, FLEET, FLEET_T).permute(1, 0, 2).contiguous()

    fab = [(fleet(SEED + 50 + 2 * k), fleet(SEED + 51 + 2 * k)) for k in range(REPS)]
    fshape = f"{FLEET}x({FLEET_T}x{FLEET_T})"
    fbytes = FLEET * w * FLEET_T * FLEET_T * 4
    ms, pms = time_pair(kernels.mul_chunks, kernels.mul_chunks_plain, fab)
    report("mul_chunks", fshape, fbytes, ms, pms, batched=True,
           bnd=bound(mul_bytes(w, FLEET_T, FLEET_T, FLEET)))
    ms, pms = time_pair(lambda x, y: kernels.mul_decrypt(x, y, m),
                        lambda x, y: kernels.mul_decrypt_plain(x, y, m), fab)
    report("mul_decrypt", fshape, fbytes, ms, pms, batched=True,
           bnd=bound(mul_bytes(w, FLEET_T, FLEET_T, FLEET) + 4 * w + 8 * FLEET))
    fprods = [(kernels.mul_chunks(x, y),) for x, y in fab]
    del fab
    ms, pms = time_pair(lambda x: kernels.decrypt_parity(x, m),
                        lambda x: kernels.decrypt_parity_plain(x, m), fprods)
    report("decrypt_parity", f"{FLEET}x{w}x{FLEET_T * FLEET_T}", fbytes, ms, pms,
           " (bytes counted over all W rows)", batched=True,
           bnd=bound(4 * nz * FLEET * FLEET_T * FLEET_T + 4 * w + 8 * FLEET))
    del fprods

    # Beneš kernels at n = 1247: K8 / K12 over 2^20 chunks, K9 over 64 x 2^14.
    # Bytes are the payload read plus written (K12: read only is the floor);
    # operations are the timed plans' network_ops per chunk (K12: plus one per
    # nonzero key word).  K8 also runs in turns with OLD_PATH forced.
    plan = p.benes_plan()
    key = sk.apply_permutation(p).mask_words
    xs = [(canon_words(ctx, (w, PERM_CHUNKS), gen, dev),) for _ in range(REPS)]
    pbytes = 2 * w * PERM_CHUNKS * 4
    pops = benes_kernels.network_ops(plan) * PERM_CHUNKS
    kops = pops + int(torch.count_nonzero(key)) * PERM_CHUNKS
    path = benes_kernels.benes_path(plan.words_pad)
    ms, pms = time_pair(lambda x: benes_kernels.apply_benes(x, plan),
                        lambda x: benes_kernels.apply_benes_plain(x, plan), xs)
    reg_ms, old_ms = time_pair(
        lambda x: benes_kernels.apply_benes(x, plan),
        lambda x: benes_kernels._benes_cuda("apply_benes", x, plan, 0, path=OLD_PATH)[0], xs)
    report("apply_benes", f"{w}x{PERM_CHUNKS}", pbytes, ms, pms,
           f", {PERM_CHUNKS / ms / 1e3:.1f} M chunks/s, {path} path; in turns with the "
           f"{OLD_PATH} path: {reg_ms:.4f} ms against {old_ms:.4f} ms", bnd=bound(pbytes, pops))
    out["apply_benes"].update(path=path, against_old_ms=reg_ms, old_path=OLD_PATH,
                              old_path_ms=old_ms)
    ms, pms = time_pair(lambda x: benes_kernels.apply_benes_decrypt(x, plan, key),
                        lambda x: benes_kernels.apply_benes_decrypt_plain(x, plan, key), xs)
    fused_ms, staged_ms = time_pair(
        lambda x: benes_kernels.apply_benes_decrypt(x, plan, key),
        lambda x: kernels.decrypt_parity(benes_kernels.apply_benes(x, plan), key), xs)
    report("apply_benes_decrypt", f"{w}x{PERM_CHUNKS}", pbytes, ms, pms,
           f"; staged K8 + K3 {staged_ms:.4f} ms against fused {fused_ms:.4f} ms in turns",
           bnd=bound(pbytes + 4 * w + 8, kops))
    out["apply_benes_decrypt"].update(staged_ms=staged_ms, fused_ms=fused_ms)
    del xs
    kc = 1 << 14
    xb = [(canon_words(ctx, (stacked.k, w, kc), gen, dev),) for _ in range(REPS)]
    kbytes = 2 * stacked.k * w * kc * 4
    ms, pms = time_pair(lambda x: benes_kernels.apply_benes_batch(x, stacked),
                        lambda x: benes_kernels.apply_benes_batch_plain(x, stacked), xb)
    report("apply_benes_batch", f"{stacked.k}x{w}x{kc}", kbytes, ms, pms,
           f", {stacked.k * kc / ms / 1e3:.1f} M chunks/s",
           bnd=bound(kbytes, sum(benes_kernels.network_ops(stacked)) * kc))
    return out


def _forced(name, plan, path, key=None, stride=0):
    """A Beneš wrapper's kernel launched on `path` (timing only)."""
    return lambda x: benes_kernels._benes_cuda(name, x, plan, stride, key, path=path)[0]


def lane_timings(gen, pkeys, dev, card: str, wide_perms, bound) -> dict:
    """The Beneš kernel past 2048 bits.  The lane-group path's K8 in turns
    with the wide kernel forced (at n = 4095 over 2^20 chunks, at LANES_N
    and n = 40000 over WIDE_CHUNKS chunks); its K12 and K9 (four plans over
    a quarter of the chunks each);
    the wide kernel at WIDE_N against its global-scratch form.  Bytes: the
    payload read and written; operations: the plans' `network_ops` per chunk
    (K12: plus one per nonzero key word)."""
    out = {}
    rows = []
    for n, chunks, old in ((4095, PERM_CHUNKS, OLD_PATH), (LANES_N, WIDE_CHUNKS, "wide"),
                           (40000, WIDE_CHUNKS, "wide"), (WIDE_N, WIDE_CHUNKS, "global")):
        ctx = Context(n, 16)
        p, q, r = wide_perms[n] if n in wide_perms else (
            Permutation.random(n, next(pkeys)) for _ in range(3))
        plan = p.benes_plan()
        path = benes_kernels.benes_path(plan.words_pad)
        sk = SecretKey(ctx, core.keygen(next(pkeys), n, ctx.d).numpy(), device=dev)
        key = sk.apply_permutation(p).mask_words
        w = ctx.words32
        xs = [(canon_words(ctx, (w, chunks), gen, dev),) for _ in range(REPS)]
        nbytes = 2 * w * chunks * 4
        ops = benes_kernels.network_ops(plan) * chunks
        ms, pms = time_pair(lambda x: benes_kernels.apply_benes(x, plan),
                            lambda x: benes_kernels.apply_benes_plain(x, plan), xs)
        new_ms, old_ms = time_pair(lambda x: benes_kernels.apply_benes(x, plan),
                                   _forced("apply_benes", plan, old), xs)
        k12_ms, k12_plain_ms = time_pair(
            lambda x: benes_kernels.apply_benes_decrypt(x, plan, key),
            lambda x: benes_kernels.apply_benes_decrypt_plain(x, plan, key), xs)
        row = {"n": n, "path": path, "shape": f"{w}x{chunks} (n={n})", "ms": ms,
               "plain_ms": pms, "against_old_ms": new_ms, "old_path": old, "old_path_ms": old_ms,
               "k12_ms": k12_ms, "k12_plain_ms": k12_plain_ms, **bound(nbytes, ops),
               "library_ms": None}
        k12_bnd = bound(nbytes + 4 * w + 8, ops + int(torch.count_nonzero(key)) * chunks)
        row["k12_bound_ms"] = k12_bnd["bound_ms"]
        del xs
        if path == "lanes":
            stacked = pb.stack_plans([p.benes_plan(), q.benes_plan(), r.benes_plan(),
                                      p.inverse().benes_plan()])
            kc = chunks // stacked.k
            xb = [(canon_words(ctx, (stacked.k, w, kc), gen, dev),) for _ in range(REPS)]
            row["k9_ms"], row["k9_plain_ms"] = time_pair(
                lambda x: benes_kernels.apply_benes_batch(x, stacked),
                lambda x: benes_kernels.apply_benes_batch_plain(x, stacked), xb)
            row["k9_bound_ms"] = bound(nbytes, sum(benes_kernels.network_ops(stacked)) * kc)[
                "bound_ms"]
            row["k9_shape"] = f"{stacked.k}x{w}x{kc}"
            del xb
        out[f"{path}_{n}"] = row
        rows.append(row)
        print(f"[time] apply_benes n={n} (WP={plan.words_pad}, {path} path) {w}x{chunks}: "
              f"kernel {ms:.4f} ms ({chunks / ms / 1e3:.2f} M chunks/s), plain {pms:.4f} ms; "
              f"in turns with the {old} path: {new_ms:.4f} ms against {old_ms:.4f} ms"
              + f"; K12 {k12_ms:.4f} ms (plain {k12_plain_ms:.4f}, bound "
              f"{row['k12_bound_ms']:.4f})"
              + (f"; K9 {row['k9_shape']} {row['k9_ms']:.4f} ms (plain "
                 f"{row['k9_plain_ms']:.4f}, bound {row['k9_bound_ms']:.4f})"
                 if path == "lanes" else "")
              + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {ops // chunks} ops a "
              f"chunk), share {row['bound_ms'] / ms:.3f}; {card}")
    out["K8l"] = out[f"lanes_{LANES_N}"]
    out["K8w"] = out[f"wide_{WIDE_N}"]
    return out


def fresh_pairs(sk, gen, dev, t1: int, t2: int, seed: int) -> list:
    """REPS distinct operand pairs of fresh encrypts ([W, t1], [W, t2]) of
    random bits under counter seeds from `seed` on."""
    def one(t, s):
        bits = torch.randint(0, 2, (t,), dtype=torch.int32, device=dev, generator=gen)
        return sk.encrypt_batch(bits, s)
    return [(one(t1, seed + 2 * k), one(t2, seed + 2 * k + 1)) for k in range(REPS)]


def mode_timings(ctx, sk, gen, dev, card: str, bound) -> dict:
    """The multiply's unaligned and b-streamed modes: each against its plain
    version, against the aligned mode at (nearly) equal product bytes, the
    unaligned mode against the 4-byte-store walk it replaces, the b-streamed
    mode against the aligned walk at its own shape, and the product forms
    against the library call; then the streaming threshold sweep.  Keys are
    the TPU kernels' ids."""
    m = sk.mask_words
    w = ctx.words32
    out = {}
    fresh = functools.partial(fresh_pairs, sk, gen, dev)

    def forced(mode, count):
        mask = m if count else None
        name = "mul_decrypt" if count else "mul_chunks"
        return lambda x, y: kernels._mul_cuda(name, x, y, mask, mode=mode)

    def mul(count):
        return (lambda x, y: kernels.mul_decrypt(x, y, m)) if count else kernels.mul_chunks

    def plain(count):
        return (lambda x, y: kernels.mul_decrypt_plain(x, y, m)) if count \
            else kernels.mul_chunks_plain

    def both(f, g):  # time f on the first operand pair against g on the second
        return (lambda x, y, x2, y2: f(x, y)), (lambda x, y, x2, y2: g(x2, y2))

    aligned_in = fresh(MAIN_T, MAIN_T, SEED + 700)              # 16,777,216 chunks
    half_in = fresh(MAIN_T // 2, MAIN_T, SEED + 720)            # 2^23 chunks
    rows = [("K10", "unaligned", CHAIN_T[0] * CHAIN_T[1], CHAIN_T[2], False, aligned_in),
            ("K11a", "unaligned", *RAGGED_T, False, aligned_in),
            ("K11b", "unaligned", *RAGGED_T, True, aligned_in),
            ("K6a", "tiled", *STREAM_T, False, half_in),
            ("K6b", "tiled", *STREAM_T, True, half_in)]
    for tid, mode, t1, t2, count, ref_in in rows:
        ins = fresh(t1, t2, SEED + 740)
        require(kernels.mul_mode(w, t1, t2, True) == mode, f"{tid} shape not {mode}")
        nbytes = w * t1 * t2 * 4
        ms, pms = time_pair(mul(count), plain(count), ins)
        other = "vec1" if mode == "unaligned" else "aligned"
        ms2, other_ms = time_pair(mul(count), forced(other, count), ins)
        paired = [a + b for a, b in zip(ins, ref_in)]
        ms3, eq_ms = time_pair(*both(mul(count), forced("aligned", count)), paired)
        rt1, rt2 = ref_in[0][0].shape[-1], ref_in[0][1].shape[-1]
        lib_ms = None if count else time_pair(library_and, mul(count), ins)[0]
        bnd = bound(mul_bytes(w, t1, t2) + (4 * w + 8 if count else 0))
        out[tid] = {"shape": f"{t1}x{t2}", "ms": ms, "plain_ms": pms,
                    f"{other}_same_shape_ms": other_ms, "against_it_ms": ms2,
                    "aligned_equal_bytes_ms": eq_ms, "aligned_shape": f"{rt1}x{rt2}",
                    "against_aligned_ms": ms3, **bnd, "library_ms": lib_ms}
        lib = "" if lib_ms is None else f"; library {lib_ms:.4f} ms"
        print(f"[time] {tid} {'mul_decrypt' if count else 'mul_chunks'} {mode} {t1}x{t2}: "
              f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain {pms:.4f} ms; "
              f"{other} walk at this shape {other_ms:.4f} ms against {ms2:.4f}; aligned "
              f"{rt1}x{rt2} ({w * rt1 * rt2 * 4 / 1e9:.3f} GB) {eq_ms:.4f} ms against "
              f"{ms3:.4f}; bound {bnd['bound_ms']:.4f} ms{lib}; {card}")
        del ins, paired
    del aligned_in, half_in

    # The batched count form of the tiled mode (K6b on [B, W, C]): the 2-D
    # row's shape twice, b of each element past the streaming threshold.
    def fresh_batched(seed):
        def one(t, s):
            bits = torch.randint(0, 2, (2 * t,), dtype=torch.int32, device=dev, generator=gen)
            return sk.encrypt_batch(bits, s).reshape(w, 2, t).permute(1, 0, 2).contiguous()
        return [(one(STREAM_T[0], seed + 2 * k), one(STREAM_T[1], seed + 2 * k + 1))
                for k in range(REPS)]

    ins = fresh_batched(SEED + 750)
    require(kernels.mul_mode(w, *STREAM_T, True) == "tiled", "K6b batched shape not tiled")
    before = kernels.LAUNCHES["mul_decrypt_tiled_batched"]
    ms, pms = time_pair(mul(True), plain(True), ins)
    launched = kernels.LAUNCHES["mul_decrypt_tiled_batched"] - before
    bnd = bound(mul_bytes(w, *STREAM_T, 2) + 4 * w + 16)
    out["K6b_batched"] = {"shape": f"2x({STREAM_T[0]}x{STREAM_T[1]})", "ms": ms, "plain_ms": pms,
                          "timed_launches": launched, **bnd, "library_ms": None}
    print(f"[time] K6b mul_decrypt tiled batched 2x({STREAM_T[0]}x{STREAM_T[1]}): kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"share {bnd['bound_ms'] / ms:.3f}; {launched} launches of the batched tiled count "
          f"form timed; {card}")
    del ins

    # Small t2 at ~2^24 chunks: t2 = 1 and 3, against the 4-byte walk.
    for t2 in (1, 3):
        t1 = ((1 << 24) - 1) // t2
        ins = fresh(t1, t2, SEED + 760)
        ms, pms = time_pair(kernels.mul_chunks, kernels.mul_chunks_plain, ins)
        ms2, v1 = time_pair(kernels.mul_chunks, forced("vec1", False), ins)
        out[f"unaligned_t2_{t2}"] = {"shape": f"{t1}x{t2}", "ms": ms, "plain_ms": pms,
                                     "vec1_same_shape_ms": v1, "against_it_ms": ms2}
        print(f"[time] mul_chunks unaligned {t1}x{t2}: kernel {ms:.4f} ms "
              f"({w * t1 * t2 * 4 / ms / 1e6:.1f} GB/s), plain {pms:.4f} ms; vec1 walk "
              f"{v1:.4f} ms against {ms2:.4f}; {card}")
        del ins

    # Streaming threshold: b from 10.5 to 84 MB at t1 = 16, tiled against aligned.
    sweep = {}
    for e in (16, 17, 18, 19):
        ins = fresh(16, 1 << e, SEED + 780)
        ms, ams = time_pair(forced("tiled", False), forced("aligned", False), ins)
        sweep[f"b={w * 4 << e}"] = {"tiled_ms": ms, "aligned_ms": ams}
        print(f"[time] threshold sweep 16x2^{e} (b {w * 4 << e >> 20} MiB): tiled "
              f"{ms:.4f} ms, aligned walk {ams:.4f} ms; {card}")
        del ins
    out["threshold_sweep"] = sweep
    return out


def order_timings(ctx, sk, gen, dev, card: str, bound, pkeys) -> dict:
    """Lazy order's costs, each in turns: the swapped route (K1 / K2 on
    (b, a), a j-major product) against the tiled mode at 16 x 2^19, as
    kernels and as the public `*` and `mul_and_decrypt` (forced onto the
    swapped route against the port's canonical route), with the tag's
    construction and the canonical() gather alone; and the one-hot
    permutation against K8 at n = 1247 over 2^20 chunks."""
    m = sk.mask_words
    w = ctx.words32
    out = {}
    fresh = functools.partial(fresh_pairs, sk, gen, dev)

    def swapped(fn):   # the public call forced onto the swapped route
        def run(x, y):
            with forced_jmajor():
                return fn(x, y)
        return run

    def rounds(f, g, ins):
        """Medians of ORDER_ROUNDS rounds of `time_pair` (the public calls'
        host work makes one round noisier than a kernel's)."""
        pairs = [time_pair(f, g, ins) for _ in range(ORDER_ROUNDS)]
        return statistics.median(a for a, _ in pairs), statistics.median(b for _, b in pairs)

    t1, t2 = STREAM_T
    ins = fresh(t1, t2, SEED + 900)
    swapped_mode = kernels.mul_mode(w, t2, t1, True)
    sw, tiled = time_pair(lambda x, y: kernels.mul_chunks(y, x), kernels.mul_chunks, ins)
    swd, tiledd = time_pair(lambda x, y: kernels.mul_decrypt(y, x, m),
                            lambda x, y: kernels.mul_decrypt(x, y, m), ins)
    cts = [(Ciphertext(x, ctx), Ciphertext(y, ctx)) for x, y in ins]
    api_sw, api = rounds(swapped(operator.mul), operator.mul, cts)
    apid_sw, apid = rounds(swapped(sk.mul_and_decrypt), sk.mul_and_decrypt, cts)
    tag_ms = run_ms(lambda: order.cross_logical(None, None, t1, t2, jmajor=True, device=dev),
                    [()] * REPS)
    canon_ms = run_ms(lambda c: c.canonical(), [(swapped(operator.mul)(x, y),)
                                                for x, y in cts[:2]])
    bnd = bound(mul_bytes(w, t1, t2))
    out["swap"] = {"shape": f"{t1}x{t2}", "swapped_mode": swapped_mode, "swapped_ms": sw,
                   "tiled_ms": tiled, "swapped_count_ms": swd, "tiled_count_ms": tiledd,
                   "api_mul_swapped_ms": api_sw, "api_mul_ms": api,
                   "api_mul_and_decrypt_swapped_ms": apid_sw, "api_mul_and_decrypt_ms": apid,
                   "tag_ms": tag_ms, "canonical_ms": canon_ms, **bnd}
    print(f"[time] swap {t1}x{t2}: swapped ({swapped_mode}) {sw:.4f} ms against tiled "
          f"{tiled:.4f} ms; count forms {swd:.4f} against {tiledd:.4f} ms; `*` swapped "
          f"{api_sw:.4f} against the port's route {api:.4f} ms; mul_and_decrypt swapped "
          f"{apid_sw:.4f} against {apid:.4f} ms (medians of {ORDER_ROUNDS} rounds); the tag "
          f"alone {tag_ms:.4f} ms, canonical() {canon_ms:.4f} ms; bound "
          f"{bnd['bound_ms']:.4f} ms; {card}")
    del ins, cts

    perm = Permutation.random(ctx, next(pkeys))
    plan = perm.benes_plan()
    onehot = permute_mxu.onehot_matrix(perm.perm, ctx.n, dev)
    ins = [(rand_words(ctx, PERM_CHUNKS, gen, dev),) for _ in range(REPS)]
    k8, mx = time_pair(lambda x: benes_kernels.apply_benes(x, plan),
                       lambda x: permute_mxu.permute_chunks_mxu(x, onehot, ctx.n), ins)
    out["mxu_1247"] = {"chunks": PERM_CHUNKS, "k8_ms": k8, "mxu_ms": mx,
                       "mxu_matmul_flop": 2 * onehot.shape[0] ** 2 * PERM_CHUNKS}
    print(f"[time] permute_chunks_mxu n={ctx.n} over {PERM_CHUNKS} chunks: {mx:.4f} ms against "
          f"K8 {k8:.4f} ms; {card}")
    del ins
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile phases 4b and 4c (the key-rotation and the "
                             "circuit paths)")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    bound = Bounds(sm_mhz)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, capability {torch.cuda.get_device_capability(0)}; "
          f"max SM clock {sm_mhz:.0f} MHz: bounds at {HBM_BYTES_PER_S / 1e12:.2f} TB/s and "
          f"{bound.int_ops_per_s / 1e12:.2f} T int32 op/s")

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] {_build.library_path().name} from csgn_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    resources = _build.kernel_resources()
    watched = [r for r in resources if any(
        k in r["kernel"] for k in ("benes_", "fill_kernel", "philox_tile_kernel", "JaxThreefry"))]
    require(len(watched) == 34, f"ptxas reported {len(watched)} Beneš, fill, Philox tile and "
            "K14 kernels, not 14 register + 10 lane-group + 6 wide + 1 fill + 2 tile + 1 K14")
    for r in resources:  # every Beneš, fill, Philox tile and K14 kernel, and any other that spills
        spills = r["spill_stores"] or r["spill_loads"]
        if r in watched or spills:
            print(f"[build] {r['kernel']}: {r['registers']} registers, spill stores "
                  f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
        require(r not in watched or not spills, f"{r['kernel']} spills")

    ctx = Context(1247, 16)
    keys = prng.split(prng.key(SEED), 4)     # jax.random.split(jax.random.key(SEED), 4)
    indices = core.keygen(keys[0], ctx.n, ctx.d).numpy()
    rng = np.random.default_rng(SEED)
    sk = SecretKey(ctx, indices, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    pkeys = key_stream(SEED)  # permutations and Beneš keys are drawn on the host

    # Phase 3: kernels vs plain.
    errs = dict.fromkeys([name for _, name, _, _ in KERNELS], 0)
    check_kernels(ctx, sk, gen, dev, errs)
    check_batched(ctx, sk, gen, dev, errs)
    check_modes(ctx, sk, gen, dev, errs)
    check_benes(gen, pkeys, dev, errs)
    wide_perms = check_benes_wide(gen, pkeys, dev, errs)
    check_philox(gen, dev, errs)
    check_threefry(ctx, sk, gen, dev, errs)
    check_fill(dev, errs)
    torch.cuda.synchronize()

    # Phase 4: the main path.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    main_launches, prod = main_path(ctx, keys, rng, dev)
    torch.cuda.empty_cache()

    # Phase 4b: the key-rotation path.  Host routing of the plans is set-up.
    p = Permutation.random(ctx, next(pkeys))
    perms = [Permutation.random(ctx, next(pkeys)) for _ in range(FLEET)]
    t0 = time.perf_counter()
    stacked = pb.stack_plans([q.benes_plan() for q in perms])
    p.benes_plan()
    print(f"[rotate] {FLEET + 1} Beneš plans routed on the host in "
          f"{time.perf_counter() - t0:.2f} s (cached on each Permutation)")
    torch.cuda.reset_peak_memory_stats(dev)
    rot_launches = rotation_path(ctx, indices, prod, p, perms, rng, dev)
    if args.profile:
        profile_path("rotation", lambda: rotation_path(
            ctx, indices, prod, p, perms, np.random.default_rng(1), dev), warm=3)
    del prod
    torch.cuda.empty_cache()

    # Phase 4c: the circuit and serving path.  Netlists and plans are set-up.
    setup = circuit_setup(ctx, pkeys)
    torch.cuda.reset_peak_memory_stats(dev)
    circ_launches, _ = circuit_path(ctx, indices, setup, rng, dev)
    if args.profile:
        profile_path("circuit", lambda: circuit_path(
            ctx, indices, setup, np.random.default_rng(2), dev), warm=1)
    torch.cuda.empty_cache()

    # Phase 4d: the entry points, on their default device.
    torch.cuda.reset_peak_memory_stats(dev)
    entry_launches, _ = entry_path(ctx, indices, rng, pkeys)
    torch.cuda.empty_cache()

    # Phases 4e and 4f in one job of one rank over NCCL, destroyed before
    # phase 5: the sharded path, then the user programs (sharded_pipeline
    # and scaling_bench run in this job).
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    try:
        job_dev = parallel.initialize(f"file://{SHARD_DIR / 'store'}", 1, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        shard_launches, _ = sharded_path(ctx, indices, rng, pkeys, wide_perms, smi, job_dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        prog_launches, _ = programs_path(smi)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # Phase 4g: the headline benchmark program, outside 4e's job.
    torch.cuda.reset_peak_memory_stats(dev)
    bench_launches, _ = bench_path(smi)
    torch.cuda.empty_cache()

    # Phase 4h: lazy chunk order.
    torch.cuda.reset_peak_memory_stats(dev)
    order_launches, _ = order_path(ctx, indices, rng, pkeys, gen, dev)
    torch.cuda.empty_cache()

    # Phase 5: timings.
    times = timings(ctx, sk, gen, dev, smi, p, stacked, bound)
    times.update(mode_timings(ctx, sk, gen, dev, smi, bound))
    times.update(lane_timings(gen, pkeys, dev, smi, wide_perms, bound))
    times.update(order_timings(ctx, sk, gen, dev, smi, bound, pkeys))
    torch.cuda.synchronize()
    # The swapped route beside the mode it replaces at 16 x 2^19 (K6a / K6b's shape).
    times["K6a"]["swapped_route_ms"] = times["swap"]["swapped_ms"]
    times["K6b"]["swapped_route_ms"] = times["swap"]["swapped_count_ms"]
    extra = ("unaligned_t2_1", "unaligned_t2_3", "threshold_sweep", "K6b_batched",
             "lanes_4095", "lanes_40000", "swap", "mxu_1247")
    print(f"[time] mode timings {json.dumps({k: times[k] for k in extra})}")

    rows = []
    paths = (("main", main_launches), ("rotation", rot_launches), ("circuit", circ_launches),
             ("entry", entry_launches), ("sharded", shard_launches),
             ("programs", prog_launches), ("bench", bench_launches), ("order", order_launches))
    for tid, name, src, rep in KERNELS:
        by_path = {path: launches.get(name, 0) + launches.get(name + "_batched", 0)
                   for path, launches in paths}
        rows.append({
            "name": name, "tpu_kernel": tid, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], **times[tid if tid in times else name],
        })
    print(f"[time] whole script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
