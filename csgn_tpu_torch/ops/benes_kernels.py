"""CUDA kernels for the Beneš permutation, with their plain torch versions.

  * K8 `apply_benes` — one plan over ``[W, C]``, or over every element of a
    batch ``[B, W, C]`` (csrc/benes.cu; replaces
    csgn_tpu/ops/permute_benes.py `apply_benes_pallas`).
  * K9 `apply_benes_batch` — plan i on element i of ``[k, W, C]``
    (csrc/benes.cu with a plan stride; replaces `apply_benes_batch_pallas`),
    and `apply_benes_requests`, the same on k ``[W, C]`` tensors and k plans
    read where they are stored, through a device table of their base
    pointers (the register path's table form), into one ``[k, W, C]`` output.
  * K12 `apply_benes_decrypt` — K8 plus the decrypt count of the permuted
    output against the OUTPUT key (csrc/benes.cu count mode; replaces
    `apply_benes_decrypt_pallas`).

The plain versions are `ops.permute_benes.apply_benes`, `apply_benes_batch`
and `apply_benes_decrypt_plain`.  Routing is by the tensors' device, as in
`ops.kernels`: a CPU tensor goes to the plain version, a CUDA tensor
launches the kernel or raises.  Each launch adds one to
``LAUNCHES[<wrapper name>]``, and its CUDA body is the span
``launch.<wrapper name>`` while spans are recorded (`utils.metrics`), and
each call that launches counts ``<wrapper name>.<path>`` there (the path
below: ``apply_benes.lanes``, ``apply_benes_batch.register``, ...).

csrc/benes.cu and csrc/benes_lanes.cu have three paths, chosen by the
network's width WP = n_pad / 32 (`benes_path`), all counted under the same
``LAUNCHES`` keys:

  * "register" for WP <= `REGISTER_WORDS_PAD` (64, n <= 2048): each thread
    keeps its chunk column in registers, the rows unrolled at compile time
    for each WP in 1, 2, 4, ..., 64, in blocks of 256 columns; its in-word
    stages rely on a plan's in-word masks marking only the upper bit of
    each pair, as `permute_benes.build_plan`'s do;
  * "lanes" up to `LANES_WORDS_PAD` (2048, n <= 65536): a group of WP /
    `LANE_WORDS` lanes of a warp keeps the column in registers,
    `LANE_WORDS` rows a lane, the plan's masks in the layout of
    `lane_masks`; its launches also count under ``LAUNCHES["benes_lanes"]``.
    It has two forms (`lanes_form`): "ring" at WP = 128 on 16-byte aligned
    rows (a persistent grid whose blocks stage the plan once and move each
    tile in and out by one TMA tensor copy; counted ``<wrapper>.lanes.ring``
    too) and "tile" elsewhere (one block a tile);
  * "wide" above, at any n: a block's threads split each stage's rows over
    a tile of up to 32 chunk columns (four columns a thread), the masks read
    from global memory; the tile is in shared memory while one column fits
    (WP <= 32768) and else in a global scratch that the wrapper allocates
    (``path="global"`` forces that form, for tests and timing).  Its
    launches also count under ``LAUNCHES["benes_wide"]``.

This is routing by shape, not a fallback: a build or launch failure of any
path raises, and only an allocation the card cannot hold refuses a size.
`network_deltas` is the stage sequence every plan of an n_pad has, and
`network_ops` the integer operations per chunk that bound the kernels on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.ops._build import LAUNCHES, check, grids, lib, ptr, stream_of
from csgn_tpu_torch.ops.kernels import _check_operands
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "LAUNCHES",
    "apply_benes",
    "apply_benes_plain",
    "apply_benes_batch",
    "apply_benes_batch_plain",
    "apply_benes_requests",
    "apply_benes_decrypt",
    "apply_benes_decrypt_plain",
    "benes_path",
    "lane_masks",
    "lanes_form",
    "network_deltas",
    "network_ops",
    "LANE_WORDS",
    "LANES_WORDS_PAD",
    "REGISTER_WORDS_PAD",
    "WIDE_TILE_WORDS_PAD",
]

apply_benes_plain = pb.apply_benes
apply_benes_batch_plain = pb.apply_benes_batch
apply_benes_decrypt_plain = pb.apply_benes_decrypt_plain

# The register path holds a chunk column of WP words in registers (64 of a
# thread's 255 at WP = 64, with no spills); the lane-group path splits it
# over WP / LANE_WORDS lanes (2 to 32) of LANE_WORDS words each, up to
# LANES_WORDS_PAD (n <= 65536); the wide path takes every wider network.
# Its tile holds at least one column of WP words in the 227 KB of shared
# memory a block may use, up to WIDE_TILE_WORDS_PAD; past it each block's
# tile of _WIDE_GLOBAL_CHUNKS columns lives in a global scratch.  LANE_WORDS
# must equal csrc/benes_lanes.cu's kLaneWords.
REGISTER_WORDS_PAD = 64
LANE_WORDS = 64
LANES_WORDS_PAD = 2048
WIDE_TILE_WORDS_PAD = 32768
RING_WORDS_PAD = 128
_WIDE_GLOBAL_CHUNKS = 32
_PATH_CODES = {"register": 0, "lanes": 1, "wide": 2, "global": 3, "ring": 4, "table": 5}
_PATH_LAUNCHES = {"lanes": "benes_lanes", "wide": "benes_wide", "global": "benes_wide"}


def benes_path(words_pad: int) -> str:
    """The path of csrc/benes.cu for a network of `words_pad` words:
    "register" up to `REGISTER_WORDS_PAD`, "lanes" up to
    `LANES_WORDS_PAD`, "wide" above."""
    if words_pad <= REGISTER_WORDS_PAD:
        return "register"
    return "lanes" if words_pad <= LANES_WORDS_PAD else "wide"


def lanes_form(words_pad: int, chunks: int, aligned: bool = True) -> str:
    """The lane-group path's form for a network of `words_pad` words over
    rows of `chunks` words: "ring" where csrc/benes_lanes.cu's ring form
    takes it (WP = 128, every row start on a 16-byte boundary: chunks % 4 ==
    0 and `aligned` base addresses of the words and the output), else
    "tile"."""
    return "ring" if words_pad == RING_WORDS_PAD and chunks % 4 == 0 and aligned else "tile"


def lane_masks(plan, device) -> torch.Tensor:
    """The plan's masks in the lane-group path's layout, copied once per
    device and cached on the plan: per stage ``[K/4, L, 4]`` (K =
    `LANE_WORDS`, L = WP / K), where word ``[i // 4, q, i % 4]`` is network
    row ``i * L + q``, local row i of lane q.  A `StackedPlans` keeps its
    leading plan axis."""
    key = f"{torch.device(device)}/lanes"
    ops = plan._device.get(key)
    if ops is None:
        masks, _ = pb.device_operands(plan, device)
        k = LANE_WORDS
        lanes = plan.words_pad // k
        *lead, stages, _ = masks.shape
        ops = (masks.reshape(*lead, stages, k // 4, 4, lanes).transpose(-1, -2)
               .contiguous().reshape(masks.shape))
        plan._device[key] = ops
    return ops


def network_deltas(n_pad: int) -> tuple[int, ...]:
    """The stage deltas of every Beneš plan on `n_pad` bits: 1, 2, ...,
    n_pad/2, ..., 2, 1 (`permute_benes._route`).  The register path unrolls
    one block per cross-word delta of this sequence."""
    up = tuple(1 << i for i in range(n_pad.bit_length() - 1))
    return up + up[-2::-1]


def network_ops(plan) -> int | list[int]:
    """Integer operations per chunk of a plan's network, the fewest the
    H100 can issue them in, a three-input logic op (LOP3) counting one: 4
    per nonzero in-word mask word (``t = (v ^ (v << d)) & m`` is a shift and
    a LOP3, ``v ^ t ^ (t >> d)`` a shift and a LOP3) and 2 per nonzero
    cross-word pair (each word is a bit select of the two under the mask,
    one LOP3), over each stage's live rows.  A `StackedPlans` gives one
    count per plan."""
    masks = plan.masks if plan.masks.ndim == 3 else plan.masks[None]
    ops = np.zeros(len(masks), dtype=np.int64)
    for s, (delta, rows) in enumerate(zip(plan.deltas, plan.rows)):
        live = np.count_nonzero(masks[:, s, :rows], axis=1)
        ops += live * (4 if delta < 32 else 2)
    return int(ops[0]) if plan.masks.ndim == 2 else [int(x) for x in ops]


def _benes_cuda(name: str, words: torch.Tensor, plan, plan_stride: int,
                key: torch.Tensor | None = None, path: str | None = None):
    """Launch csrc/benes.cu on `path` (default: `benes_path`'s pick), under
    the span ``launch.<name>``."""
    path = path or benes_path(plan.words_pad)
    if path in ("register", "lanes") and plan.deltas != network_deltas(plan.n_pad):
        raise ValueError(f"{name}: stage deltas {plan.deltas} are not the "
                         f"{plan.n_pad}-bit network's")
    with op_metrics().span(f"launch.{name}"):
        masks, sched = pb.device_operands(plan, words.device)
        if path == "lanes":
            masks = lane_masks(plan, words.device)
        *lead, w, c = words.shape
        out = torch.empty_like(words)
        count = None if key is None else torch.zeros(lead, dtype=torch.int64,
                                                     device=words.device)
        if words.numel():
            batch = lead[0] if lead else 1
            form = None
            if path == "lanes":
                aligned = words.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
                form = lanes_form(plan.words_pad, c, aligned)
            scratch = None
            if path == "global" or (path == "wide" and plan.words_pad > WIDE_TILE_WORDS_PAD):
                blocks = -(-c // _WIDE_GLOBAL_CHUNKS)
                scratch = torch.empty((batch, blocks * _WIDE_GLOBAL_CHUNKS, plan.words_pad),
                                      dtype=torch.int32, device=words.device)
            with torch.cuda.device(words.device):
                check(name, lib().csgn_benes(
                    ptr(words), ptr(masks), ptr(sched), ptr(key), ptr(out), ptr(count),
                    ptr(scratch), batch, w, c, plan.words_pad, len(plan.deltas),
                    min(w, plan.words_pad), plan_stride,
                    _PATH_CODES["ring" if form == "ring" else path], stream_of(words)
                ))
            LAUNCHES[name] += grids(batch)
            if path in _PATH_LAUNCHES:
                LAUNCHES[_PATH_LAUNCHES[path]] += grids(batch)
            op_metrics().count(f"{name}.{path}")
            if form == "ring":
                op_metrics().count(f"{name}.lanes.ring")
        return out, count


def apply_benes(words: torch.Tensor, plan: pb.BenesPlan) -> torch.Tensor:
    """Permute every chunk of [W, C] (or of every element of [B, W, C]) by
    the plan: out bit i = in bit perm[i]."""
    _check_operands("apply_benes", (words,))
    if words.device.type == "cpu":
        return apply_benes_plain(words, plan)
    return _benes_cuda("apply_benes", words, plan, 0)[0]


def apply_benes_batch(words: torch.Tensor, stacked: pb.StackedPlans) -> torch.Tensor:
    """Permute element i of [k, W, C] by plan i of `stacked`."""
    _check_operands("apply_benes_batch", (words,))
    if words.dim() != 3 or words.shape[0] != stacked.k:
        raise ValueError(f"apply_benes_batch: words must be [k={stacked.k}, W, C], "
                         f"got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return apply_benes_batch_plain(words, stacked)
    stride = len(stacked.deltas) * stacked.words_pad
    return _benes_cuda("apply_benes_batch", words, stacked, stride)[0]


def apply_benes_requests(words: list[torch.Tensor], plans: list[pb.BenesPlan]) -> torch.Tensor:
    """Permute request i, a ``[W, C]`` tensor wherever it is stored, by plans[i]
    into element i of one ``[k, W, C]`` output: K9 with no stack of its
    inputs or of its plans.  The requests share one shape, dtype and device,
    and each is contiguous; the plans share n.  On the card each plan's masks
    stay where `permute_benes.table_operands` keeps them, and one table of
    the requests' and masks' base pointers goes up by one non-blocking copy
    from pinned memory (torch's caching host allocator reuses the block only
    after the copy has landed), so nothing waits for the stream; it takes
    networks of the register path alone (`benes_path` "register", n <=
    2048).  Each launch counts under ``LAUNCHES["apply_benes_batch"]`` and
    as ``apply_benes_batch.register`` and ``apply_benes_batch.table``.  On
    the CPU the plain version runs request by request."""
    if len(words) != len(plans):
        raise ValueError(f"apply_benes_requests: {len(words)} requests for {len(plans)} plans")
    _check_operands("apply_benes_requests", tuple(words))
    if words[0].dim() != 2:
        raise ValueError(f"apply_benes_requests: requests must be [W, C], "
                         f"got {tuple(words[0].shape)}")
    if any(t.shape != words[0].shape for t in words):
        raise ValueError(f"apply_benes_requests: requests must share one shape, got "
                         f"{sorted({tuple(t.shape) for t in words})}")
    if words[0].device.type == "cpu":
        return torch.stack([apply_benes_plain(t, p) for t, p in zip(words, plans)])
    p0 = plans[0]
    if benes_path(p0.words_pad) != "register":
        raise ValueError(f"apply_benes_requests: the table form is the register path's; "
                         f"a network of {p0.words_pad} words takes {benes_path(p0.words_pad)!r}")
    if p0.deltas != network_deltas(p0.n_pad):
        raise ValueError(f"apply_benes_requests: stage deltas {p0.deltas} are not the "
                         f"{p0.n_pad}-bit network's")
    name, k = "apply_benes_batch", len(words)
    with op_metrics().span(f"launch.{name}"):
        dev = words[0].device
        masks, sched = pb.table_operands(plans, dev)
        w, c = words[0].shape
        out = torch.empty((k, w, c), dtype=torch.int32, device=dev)
        if out.numel():
            table = torch.tensor([t.data_ptr() for t in (*words, *masks)], dtype=torch.int64,
                                 pin_memory=True).to(dev, non_blocking=True)
            with torch.cuda.device(dev):
                check(name, lib().csgn_benes(
                    ptr(table), None, ptr(sched), None, ptr(out), None, None, k, w, c,
                    p0.words_pad, len(p0.deltas), min(w, p0.words_pad), 0, _PATH_CODES["table"],
                    stream_of(out)))
            LAUNCHES[name] += grids(k)
            op_metrics().count(f"{name}.register")
            op_metrics().count(f"{name}.table")
        return out


def apply_benes_decrypt(words: torch.Tensor, plan: pb.BenesPlan, mask: torch.Tensor, *,
                        return_count: bool = False):
    """Fused permute + decrypt of [W, C]: ``(permuted, parity)`` in one pass,
    or the exact int64 match count with ``return_count``.  `mask` is the
    permuted key's (`sk.apply_permutation(p).mask_words`).  Bit-exact to
    `apply_benes` then `kernels.decrypt_parity`."""
    _check_operands("apply_benes_decrypt", (words,), mask)
    if words.dim() != 2:
        raise ValueError(f"apply_benes_decrypt: words must be [W, chunks], "
                         f"got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return apply_benes_decrypt_plain(words, plan, mask, return_count=return_count)
    out, count = _benes_cuda("apply_benes_decrypt", words, plan, 0, mask)
    return out, (count if return_count else count & 1)
