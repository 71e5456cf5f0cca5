"""CUDA kernels for the Beneš permutation, with their plain torch versions.

  * K8 `apply_benes` — one plan over ``[W, C]``, or over every element of a
    batch ``[B, W, C]`` (csrc/benes.cu; replaces
    csgn_tpu/ops/permute_benes.py `apply_benes_pallas`).
  * K9 `apply_benes_batch` — plan i on element i of ``[k, W, C]``
    (csrc/benes.cu with a plan stride; replaces `apply_benes_batch_pallas`).
  * K12 `apply_benes_decrypt` — K8 plus the decrypt count of the permuted
    output against the OUTPUT key (csrc/benes.cu count mode; replaces
    `apply_benes_decrypt_pallas`).

The plain versions are `ops.permute_benes.apply_benes`, `apply_benes_batch`
and `apply_benes_decrypt_plain`.  Routing is by the tensors' device, as in
`ops.kernels`: a CPU tensor goes to the plain version, a CUDA tensor
launches the kernel or raises.  Each launch adds one to
``LAUNCHES[<wrapper name>]``.
"""

from __future__ import annotations

import torch

from csgn_tpu_torch.ops import permute_benes as pb
from csgn_tpu_torch.ops._build import LAUNCHES, check, grids, lib, ptr, stream_of
from csgn_tpu_torch.ops.kernels import _check_operands

__all__ = [
    "LAUNCHES",
    "apply_benes",
    "apply_benes_plain",
    "apply_benes_batch",
    "apply_benes_batch_plain",
    "apply_benes_decrypt",
    "apply_benes_decrypt_plain",
]

apply_benes_plain = pb.apply_benes
apply_benes_batch_plain = pb.apply_benes_batch
apply_benes_decrypt_plain = pb.apply_benes_decrypt_plain

# Shared memory holds one chunk column of the network per thread (WP words)
# plus the plan's masks (S x WP words); csrc/benes.cu fits both, with at
# least 32 columns per block, up to this width (n <= 16384).
MAX_WORDS_PAD = 512


def _benes_cuda(name: str, words: torch.Tensor, plan, plan_stride: int,
                key: torch.Tensor | None = None):
    if plan.words_pad > MAX_WORDS_PAD:
        raise ValueError(f"{name}: n_pad {plan.n_pad} exceeds the kernel's "
                         f"{MAX_WORDS_PAD * 32}-bit network")
    masks, sched = pb.device_operands(plan, words.device)
    *lead, w, c = words.shape
    out = torch.empty_like(words)
    count = None if key is None else torch.zeros(lead, dtype=torch.int64, device=words.device)
    if words.numel():
        batch = lead[0] if lead else 1
        with torch.cuda.device(words.device):
            check(name, lib().csgn_benes(
                ptr(words), ptr(masks), ptr(sched), ptr(key), ptr(out), ptr(count),
                batch, w, c, plan.words_pad, len(plan.deltas), min(w, plan.words_pad),
                plan_stride, stream_of(words)
            ))
        LAUNCHES[name] += grids(batch)
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
