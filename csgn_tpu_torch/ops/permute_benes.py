"""Permutation as a Beneš network of word-parallel delta swaps: the host
routing, and the plain torch versions of the Beneš kernels.

Counterpart of `csgn_tpu.ops.permute_benes`.  Any permutation of N = 2^m bit
positions decomposes into 2m-1 "delta swap" stages (deltas 1, 2, ...,
N/2, ..., 2, 1), each a masked exchange of bit pairs at distance delta:

  * delta < 32: in-word —  t = (X ^ (X << delta)) & M;  X ^= t ^ (t >> delta)
  * delta >= 32: across words at the same in-word shift — row rolls + mask.

The routing (`_route`, `build_plan`, `stack_plans`, `_payload_rows`,
`_plan_static`) is the JAX package's host numpy, unchanged, so the port's
plans equal its plans field by field.  A plan also caches its device
operands (`device_operands`: the masks as int32, and the kernels' stage
schedule) per device, so repeated rotations under one `BenesPlan` copy
nothing to the card.  A `StackedPlans` caches the same way, but
`CiphertextBatch.apply_permutations` stacks, and so copies, its plans anew
on every call (the span ``perm.stack_plans``; each copy counts under
``perm.plan_upload_bytes``).

`apply_benes`, `apply_benes_batch` and `apply_benes_decrypt_plain` are the
plain versions of K8, K9 and K12 (`ops.benes_kernels`): the CPU path, and
what the CUDA kernels are held against on the card.  Because ``>>`` on int32
is arithmetic, the in-word right shift is masked to ``32 - delta`` bits.

Semantics: `apply_benes(X, plan)` computes out bit i = in bit perm[i] for
every chunk — identical to `core.permute_chunks` (tests enforce equality).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from csgn_tpu_torch.ops import core
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = [
    "BenesPlan",
    "StackedPlans",
    "build_plan",
    "network_size",
    "stack_plans",
    "device_operands",
    "table_operands",
    "apply_benes",
    "apply_benes_batch",
    "apply_benes_decrypt_plain",
]


def _route(perm: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Beneš looping algorithm: stage list [(delta, swap_mask_bool[N])].

    `perm` is gather form: out[i] = in[perm[i]].  A stage's mask marks
    positions i (with (i & delta) == 0) whose pair (i, i+delta) swaps.
    """
    n = len(perm)
    assert n & (n - 1) == 0
    if n == 1:
        return []
    if n == 2:
        return [(1, np.array([perm[0] == 1, False]))]

    inv = np.argsort(perm)
    m = n // 2
    halves = np.full(n, -1, dtype=np.int8)  # which half each OUTPUT rides

    for start in range(n):
        if halves[start] != -1:
            continue
        p, h = start, 0
        while halves[p] == -1:
            halves[p] = h
            halves[p ^ 1] = 1 - h
            # the element feeding out[p^1] travels in half 1-h; its input
            # partner must take half h, surfacing at output inv[source^1].
            src = perm[p ^ 1]
            p = int(inv[src ^ 1])
            # h stays: that output must ride half h.

    pair_idx = np.arange(m)
    lcontrol = halves[2 * pair_idx] != 0            # swap at output pair i
    fcontrol = halves[inv[2 * pair_idx]] != 0       # swap at input pair j

    # Sub-permutations realized by the inner networks (top = even slots).
    out_slot_top = 2 * pair_idx + lcontrol.astype(int)
    out_slot_bot = 2 * pair_idx + (1 - lcontrol.astype(int))
    top = perm[out_slot_top] // 2
    bot = perm[out_slot_bot] // 2

    first_mask = np.zeros(n, dtype=bool)
    first_mask[2 * pair_idx[fcontrol]] = True
    last_mask = np.zeros(n, dtype=bool)
    last_mask[2 * pair_idx[lcontrol]] = True

    sub_top = _route(top)
    sub_bot = _route(bot)
    mid = []
    for (dt, mt), (db, mb) in zip(sub_top, sub_bot):
        assert dt == db
        mask = np.zeros(n, dtype=bool)
        mask[0::2] = mt
        mask[1::2] = mb
        mid.append((2 * dt, mask))
    return [(1, first_mask)] + mid + [(1, last_mask)]


def _pack_mask(mask: np.ndarray, wp: int) -> np.ndarray:
    """bool[N] -> uint32[wp] in the MSB-first layout."""
    out = np.zeros(wp, dtype=np.uint32)
    idx = np.nonzero(mask)[0]
    np.bitwise_or.at(out, idx // 32, (np.uint32(1) << (31 - idx % 32).astype(np.uint32)))
    return out


@dataclasses.dataclass(frozen=True)
class BenesPlan:
    """Precomputed routing for one permutation: per-stage (delta, packed mask).

    `rows` is the number of leading word-rows each stage must process (a
    multiple of 8, ≤ words_pad): payload bits enter the padded network in the
    first ceil(n/32) words and can only spread by the stage's word radius per
    cross-word stage (symmetrically contracting toward the output).  Mask
    bits outside the payload reach are zeroed at build time — those switches
    only ever exchanged zero padding, so dropping them is value-neutral.
    """

    n: int                      # logical bit count
    n_pad: int                  # power-of-two network size
    deltas: tuple[int, ...]
    masks: np.ndarray           # uint32[stages, n_pad/32]
    rows: tuple[int, ...]       # per-stage processed row count (8-aligned)
    _device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def words_pad(self) -> int:
        return self.n_pad // 32


def _payload_rows(n: int, n_pad: int, deltas: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Per-stage payload-row bounds.

    Returns (pb, rows): pb[s] = bound on word-rows that may hold payload
    BEFORE stage s (mask rows ≥ pb[s] are value-neutral and get zeroed);
    rows[s] = 8-aligned row count the kernel must process (pb + roll radius).
    """
    wp = n_pad // 32
    w_pay = -(-n // 32)
    s_cnt = len(deltas)
    radii = [0 if d < 32 else d // 32 for d in deltas]
    fwd = np.empty(s_cnt + 1, np.int64)
    fwd[0] = w_pay
    for s, r in enumerate(radii):
        fwd[s + 1] = min(wp, fwd[s] + r)
    bwd = np.empty(s_cnt + 1, np.int64)
    bwd[s_cnt] = w_pay
    for s in range(s_cnt - 1, -1, -1):
        bwd[s] = min(wp, bwd[s + 1] + radii[s])
    pb = np.minimum(fwd[:-1], bwd[:-1])
    rows = np.minimum(wp, -(-(pb + radii) // 8) * 8)
    return pb, rows


def network_size(n: int) -> int:
    """n_pad, the bits of every plan's network on n: the least power of two
    that holds n, and at least 32."""
    return 1 << max(5, int(np.ceil(np.log2(max(n, 2)))))


def build_plan(perm: np.ndarray, n: int) -> BenesPlan:
    """Route `perm` (gather form, length n) into a delta-swap plan."""
    perm = np.asarray(perm, dtype=np.int64)
    n_pad = network_size(n)
    full = np.concatenate([perm, np.arange(n, n_pad)])  # identity on padding
    stages = _route(full)
    wp = n_pad // 32
    deltas = tuple(int(d) for d, _ in stages)
    masks = np.stack([_pack_mask(m, wp) for _, m in stages])
    pb, rows = _payload_rows(n, n_pad, deltas)
    for s in range(len(deltas)):
        masks[s, pb[s]:] = 0  # value-neutral switches beyond payload reach
    return BenesPlan(n=n, n_pad=n_pad, deltas=deltas, masks=masks,
                     rows=tuple(int(r) for r in rows))


@dataclasses.dataclass(frozen=True)
class StackedPlans:
    """k same-size Beneš plans as one tensor: all networks on the same n_pad
    share the delta schedule AND the live row windows (both derive from
    (n, n_pad, deltas) only — see `_payload_rows`); only the per-stage masks
    differ, so k permutations batch into ``masks uint32[k, S, WP]``."""

    n: int
    n_pad: int
    deltas: tuple[int, ...]
    masks: np.ndarray           # uint32[k, stages, n_pad/32]
    rows: tuple[int, ...]
    _device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def k(self) -> int:
        return self.masks.shape[0]

    @property
    def words_pad(self) -> int:
        return self.n_pad // 32


def stack_plans(plans: list[BenesPlan]) -> StackedPlans:
    """Stack k same-(n, n_pad) plans into a `StackedPlans`."""
    if not plans:
        raise ValueError("no plans")
    p0 = plans[0]
    for p in plans[1:]:
        if p.n_pad != p0.n_pad or p.n != p0.n:
            raise ValueError("plans must share n and n_pad")
    return StackedPlans(
        n=p0.n, n_pad=p0.n_pad, deltas=p0.deltas,
        masks=np.stack([p.masks for p in plans]), rows=p0.rows,
    )


def _plan_static(plan, w: int):
    """Shared kernel prep: (deltas, rows, stage_on, w_net) for a plan or a
    `StackedPlans` (stage s is ON if any of the k plans has a live mask).

    `w_net` is the input row count the network touches: rows >= words_pad
    hold bits >= n_pad >= n, zero in canonical form (w > wp only for n < 32
    contexts, where words32 = 2 > wp = 1).
    """
    # BenesPlan masks are [S, WP]; StackedPlans are [k, S, WP] — reduce over
    # every axis except the stage axis.
    stage_axis = plan.masks.ndim - 2
    alive = plan.masks.any(axis=tuple(ax for ax in range(plan.masks.ndim) if ax != stage_axis))
    stage_on = tuple(bool(a) for a in alive)
    return plan.deltas, plan.rows, stage_on, min(w, plan.words_pad)


def device_operands(plan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(masks, schedule)`` of a `BenesPlan` or `StackedPlans` on `device`,
    copied once per device and cached on the plan.  Each copy (a cache
    miss; and `table_operands`' schedule) counts under
    ``perm.plan_upload_bytes`` (`utils.metrics`), with the bytes copied.

    masks: int32 view of the uint32 masks, ``[S, WP]`` or ``[k, S, WP]``.
    schedule: int32 ``[S, 2]`` of (delta, live rows), rows 0 for a stage
    that is off in every plan — the CUDA kernels' stage list.
    """
    key = str(torch.device(device))
    ops = plan._device.get(key)
    if ops is None:
        deltas, rows, stage_on, _ = _plan_static(plan, plan.words_pad)
        sched = np.array([(d, r if on else 0) for d, r, on in zip(deltas, rows, stage_on)],
                         dtype=np.int32).reshape(-1, 2)
        masks = np.ascontiguousarray(plan.masks, dtype=np.uint32).view(np.int32)
        ops = (torch.from_numpy(masks.copy()).to(device), torch.from_numpy(sched).to(device))
        op_metrics().count("perm.plan_upload_bytes", bytes_moved=masks.nbytes + sched.nbytes)
        plan._device[key] = ops
    return ops


def table_operands(plans: list[BenesPlan], device) -> tuple[list[torch.Tensor], torch.Tensor]:
    """What K9's table form reads of k same-(n, n_pad) plans on `device`:
    each plan's masks ``[S, WP]`` where `device_operands` keeps them (copied
    once per device and cached on the plan, so a fleet uploads no plan it
    has run before), and one schedule for all of them with every stage on
    (a stage whose masks are zero is a no-op), cached on the first plan.
    It touches ``perm.plan_upload_bytes`` even where it copies nothing, so
    a window of such calls reads 0 bytes rather than no count."""
    p0 = plans[0]
    if any(p.n_pad != p0.n_pad or p.n != p0.n for p in plans):
        raise ValueError("plans must share n and n_pad")
    op_metrics().count("perm.plan_upload_bytes", n=0)
    key = str(torch.device(device))
    masks = [(p._device.get(key) or device_operands(p, device))[0] for p in plans]
    sched = p0._device.get(f"{key}/all_stages")
    if sched is None:
        sched = torch.tensor(list(zip(p0.deltas, p0.rows)), dtype=torch.int32).reshape(-1, 2)
        sched = p0._device[f"{key}/all_stages"] = sched.to(device)
        op_metrics().count("perm.plan_upload_bytes", bytes_moved=sched.nbytes)
    return masks, sched


# ---------------------------------------------------------------------------
# Plain torch versions of K8 / K9 / K12
# ---------------------------------------------------------------------------


def _delta_swap(x: torch.Tensor, delta: int, m: torch.Tensor) -> torch.Tensor:
    """One masked delta-swap stage on int32 words ``[..., WP, C]``; `m`
    broadcasts as ``[..., WP, 1]``."""
    if delta < 32:
        t = (x ^ (x << delta)) & m
        return x ^ t ^ ((t >> delta) & ((1 << (32 - delta)) - 1))  # logical >>
    r = delta // 32
    t = (x ^ torch.roll(x, -r, dims=-2)) & m
    return x ^ t ^ torch.roll(t, r, dims=-2)


def _run_network(words: torch.Tensor, plan, mask_at) -> torch.Tensor:
    """Pad/crop rows to the network width, run every live stage, restore W.

    W may differ from the network's word count: smaller W zero-pads the rows
    and slices back (padding bits are zero and identity-routed); larger W
    (n < 32 contexts, where words32 = 2 > words_pad = 1) drops the trailing
    rows through the network — they hold bits >= n_pad >= n, zero in
    canonical form — and restores them as zeros.
    """
    w = words.shape[-2]
    wp = plan.words_pad
    x = F.pad(words, (0, 0, 0, wp - w)) if wp > w else words[..., :wp, :]
    _, _, stage_on, _ = _plan_static(plan, w)
    for s, delta in enumerate(plan.deltas):
        if stage_on[s]:  # an all-zero mask is an identity stage
            x = _delta_swap(x, delta, mask_at(s))
    if wp < w:  # restore the dropped (canonical-zero) trailing rows
        return F.pad(x, (0, 0, 0, w - wp))
    return x[..., :w, :].contiguous()


def apply_benes(words: torch.Tensor, plan: BenesPlan) -> torch.Tensor:
    """Apply the planned permutation to packed chunks int32[..., W, C] (one
    plan for every leading index).  Plain version of K8."""
    masks, _ = device_operands(plan, words.device)
    return _run_network(words, plan, lambda s: masks[s][:, None])


def apply_benes_batch(words: torch.Tensor, stacked: StackedPlans) -> torch.Tensor:
    """Apply k DIFFERENT permutations to k ciphertexts: words int32[k, W, C],
    batch element i gets plan i (the key-rotation-fleet pattern).  Plain
    version of K9."""
    if words.dim() != 3 or words.shape[0] != stacked.k:
        raise ValueError(f"apply_benes_batch: words must be [k={stacked.k}, W, C], "
                         f"got {tuple(words.shape)}")
    masks, _ = device_operands(stacked, words.device)
    return _run_network(words, stacked, lambda s: masks[:, s, :, None])


def apply_benes_decrypt_plain(words: torch.Tensor, plan: BenesPlan, mask: torch.Tensor, *,
                              return_count: bool = False):
    """Staged permute + decrypt: ``(permuted [W, C], parity)`` or, with
    ``return_count``, the exact int64 match count.  `mask` is the key of the
    OUTPUT (`sk.apply_permutation(p).mask_words`).  Plain version of K12."""
    out = apply_benes(words, plan)
    count = core.chunk_matches(out, mask).sum(dim=-1)
    return out, (count if return_count else count & 1)
