"""A dry run of the whole sharded surface at the job's world size.

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.  Every
rank of an initialized job (`parallel.initialize`) calls `run()`; it drives
each sharded op on tiny shapes at Context(95, 4) and raises on the first
result that differs from the one-device computation:

  * the batch-sharded encrypt: under an integer seed every rank's block
    equal to the one-device encrypt's columns (both names); under an
    `rng.Key` the mesh-invariant form equal to those columns of the
    one-device encrypt and the other form to the one-device encrypt of the
    block under ``fold_in(key, rank)``;
  * all-gather ≡ ring ≡ one-device product, blockwise;
  * the fused sharded multiply+decrypt ≡ the staged product and decrypt;
  * the sharded permute, decrypted under the permuted key;
  * `mul_chain_sharded`, with an all-gathered and a broadcast operand;
  * a checkpoint written at world size n and resumed on a mesh of n/2 ranks;
  * a `BatchExecutor` flush on each rank's blocks (per-rank bits XORed
    across the mesh give the one-device bits);
  * the 2-D (n/2, 2) batch x chunk step when n >= 4.

Run it in a job, e.g. one process per rank:

    from csgn_tpu_torch import parallel
    from csgn_tpu_torch.parallel import dryrun
    parallel.initialize("file:///tmp/store", world, rank, device="cpu")
    dryrun.run()
"""

from __future__ import annotations

import pathlib
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from csgn_tpu_torch import io as cio
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.models.netlist import comparator_gt, eval_plain
from csgn_tpu_torch.ops import core
from csgn_tpu_torch.parallel.batch_ops import (batch_chunk_mesh, shard_batch,
                                               sharded_decrypt_batch, sharded_mul_batch,
                                               sharded_permute_batch)
from csgn_tpu_torch.parallel.mesh import chunk_mesh
from csgn_tpu_torch.parallel.multihost import shard_ciphertext
from csgn_tpu_torch.parallel.ops import (reduce_counts, sharded_decrypt_parity,
                                         sharded_encrypt_bits, sharded_encrypt_bits_invariant,
                                         sharded_mul_allgather, sharded_mul_decrypt,
                                         sharded_mul_ring, sharded_permute)
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.pipeline import mul_chain_sharded
from csgn_tpu_torch.rng import fold_in
from csgn_tpu_torch.rng import key as rng_key
from csgn_tpu_torch.secret_key import SecretKey
from csgn_tpu_torch.serve import BatchExecutor

__all__ = ["DryRunFailure", "run"]

SEED = 7


class DryRunFailure(AssertionError):
    """A sharded result differed from the one-device computation."""


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise DryRunFailure(f"dryrun (rank {dist.get_rank()}): {what}")


def _xor_across(bit: int, mesh) -> int:
    """The XOR over the mesh's ranks of one bit per rank."""
    t = torch.tensor(int(bit), dtype=torch.int64, device=mesh.device)
    return int(reduce_counts(t, mesh)) & 1


def _shared_tempdir(mesh, workdir) -> pathlib.Path:
    """A fresh directory (under `workdir`, else the system's temporary
    directory) made by the mesh's first rank, named to all."""
    first = int(mesh.ranks.reshape(-1)[0])
    if workdir is not None:
        pathlib.Path(workdir).mkdir(parents=True, exist_ok=True)
    name = [tempfile.mkdtemp(prefix="csgn_dryrun_", dir=workdir)
            if dist.get_rank() == first else None]
    dist.broadcast_object_list(name, src=first, group=mesh.group_all)
    return pathlib.Path(name[0])


def run(workdir=None) -> dict:
    """Drive every sharded op once at the job's world size n; raise
    `DryRunFailure` on the first mismatch.  The checkpoint goes to a fresh
    directory under `workdir` (default: the system's temporary directory),
    removed afterwards.  Returns a summary dict."""
    n = dist.get_world_size()
    mesh = chunk_mesh(n)
    me = mesh.coord("c")
    dev = mesh.device
    ctx = Context(95, 4)
    rng = np.random.default_rng(SEED)
    sk = SecretKey(ctx, rng.choice(ctx.n, ctx.d, replace=False), device=dev)
    mask = sk.mask_words
    ops = sk.encrypt_operands
    per = 4
    bits = torch.tensor(np.arange(per * n) % 2, dtype=torch.int32, device=dev)
    bits[0] = 1
    expect = int(bits.sum()) % 2                     # 1: the batch as one ciphertext
    mine = slice(me * per, (me + 1) * per)

    # Batch-sharded encrypt: this rank's columns of the one-device encrypt.
    whole = sk.encrypt_batch(bits, SEED)             # [W, per * n], the one-device words
    words = sharded_encrypt_bits(SEED, bits[mine], *ops, ctx.n, ctx.d, mesh)
    inv = sharded_encrypt_bits_invariant(SEED, bits[mine], *ops, ctx.n, ctx.d, mesh)
    _require(torch.equal(words, whole[:, mine]) and torch.equal(inv, words),
             "sharded encrypt != the one-device encrypt's columns")
    key = rng_key(SEED)
    _require(torch.equal(sharded_encrypt_bits_invariant(key, bits[mine], *ops, ctx.n, ctx.d,
                                                        mesh),
                         sk.encrypt_batch(bits, key)[:, mine]),
             "sharded invariant encrypt under a key != the one-device encrypt's columns")
    _require(torch.equal(sharded_encrypt_bits(key, bits[mine], *ops, ctx.n, ctx.d, mesh),
                         sk.encrypt_batch(bits[mine], fold_in(key, me))),
             "sharded encrypt under a key != the block's encrypt under fold_in(key, rank)")

    # all-gather ≡ ring ≡ one-device product (this rank's i-block).
    t2 = per * n
    oracle = core.mul_chunks(whole, whole)[:, me * per * t2:(me + 1) * per * t2]
    prod = sharded_mul_allgather(words, words, mesh)
    ring = sharded_mul_ring(words, words, mesh)
    _require(torch.equal(prod, oracle), "all-gather product != one-device product")
    _require(torch.equal(ring, oracle), "ring product != one-device product")

    # Fused multiply+decrypt ≡ staged; the parity of c * c is that of c.
    fused, parity = sharded_mul_decrypt(words, words, mask, mesh)
    staged = int(sharded_decrypt_parity(prod, mask, mesh))
    _require(torch.equal(fused, prod), "fused sharded product != staged product")
    _require(int(parity) == staged == expect, f"parities {int(parity)}, {staged} != {expect}")

    # Sharded permute, decrypted under the permuted key.
    perm = Permutation(rng.permutation(ctx.n))
    psk = sk.apply_permutation(perm)
    permuted = sharded_permute(prod, perm.benes_plan(), mesh)
    _require(torch.equal(permuted, core.permute_chunks(prod, torch.tensor(perm.perm, device=dev),
                                                        ctx.n)), "sharded permute != gather")
    _require(int(sharded_decrypt_parity(permuted, psk.mask_words, mesh)) == expect,
             "permuted product does not decrypt under the permuted key")

    # mul_chain_sharded: a 2n-chunk accumulator times the whole batch
    # (divides the axis: all-gathered), then times 3 chunks (broadcast when
    # 3 does not divide n).
    two = Ciphertext(whole[:, :2 * n], ctx)
    three = Ciphertext(whole[:, :3], ctx)
    chain = mul_chain_sharded([shard_ciphertext(two, mesh), Ciphertext(whole, ctx), three],
                              mesh)
    want = core.mul_chunks(core.mul_chunks(two.wt, whole), three.wt)
    blk = want.shape[-1] // n
    _require(torch.equal(chain.wt, want[:, me * blk:(me + 1) * blk]),
             "mul_chain_sharded != one-device chain")

    # Checkpoint at world size n, resumed on a mesh of n // 2 ranks.
    small = chunk_mesh(max(1, n // 2))
    tmp = _shared_tempdir(mesh, workdir)
    try:
        cio.save_state_sharded(tmp, {"prod": Ciphertext(prod, ctx), "sk": sk}, mesh)
        if small.contains:
            state = cio.load_state_sharded(tmp, mesh=small)
            whole_prod = core.mul_chunks(whole, whole)
            sb = whole_prod.shape[-1] // small.shape["c"]
            i = small.coord("c")
            _require(torch.equal(state["prod"].wt, whole_prod[:, i * sb:(i + 1) * sb]),
                     "resumed block != the product's columns")
            got = int(sharded_decrypt_parity(state["prod"].wt, state["sk"].mask_words, small))
            _require(got == expect, f"resumed decrypt {got} != {expect}")
        dist.barrier(group=mesh.group_all)
    finally:
        if dist.get_rank() == int(mesh.ranks.reshape(-1)[0]):
            shutil.rmtree(tmp, ignore_errors=True)

    # BatchExecutor on this rank's blocks: per-rank bits XOR to the whole's.
    ex = BatchExecutor(sk, rng=rng_key(SEED))
    enc_bits = [1, 0, 1, 1, 0]
    enc = [ex.submit_encrypt(b) for b in enc_bits]
    md = [ex.submit_mul_decrypt(Ciphertext(words, ctx), Ciphertext(whole, ctx))
          for _ in range(2)]
    dec = ex.submit_decrypt(Ciphertext(prod, ctx))
    cases = [(2, 1), (1, 2), (3, 3), (0, 2)]
    cmp2 = comparator_gt(2)
    net = []
    for i, (x, y) in enumerate(cases):
        wires = sk.encrypt_batch([(x >> 0) & 1, (x >> 1) & 1, (y >> 0) & 1, (y >> 1) & 1],
                                 SEED + 10 + i)
        cts = [Ciphertext(wires[:, k:k + 1], ctx) for k in range(4)]
        net.append(ex.submit_netlist(cmp2, [cts[:2], cts[2:]]))
    ex.flush()
    _require(ex.stats["group_dispatches"] == 4, f"executor groups {ex.stats}")
    _require([int(sk.decrypt(f.result())) for f in enc] == enc_bits, "executor encrypts")
    for f in md:
        p, bit = f.result()
        _require(torch.equal(p.wt, prod) and _xor_across(bit, mesh) == expect,
                 "executor mul_decrypt on blocks")
    _require(_xor_across(dec.result(), mesh) == expect, "executor decrypt of blocks")
    for f, (x, y) in zip(net, cases):
        (out,) = f.result()
        want_bit = eval_plain(cmp2, [[x & 1, x >> 1], [y & 1, y >> 1]])[0][0]
        _require(int(sk.decrypt(out[0])) == want_bit == int(x > y), "executor netlist")

    _require(expect == 1, "the dry run's parity should be 1")
    summary = {"world": n, "parity": expect, "chunks": int(prod.shape[-1]) * n}
    # The 2-D (n/2, 2) batch x chunk step.
    if n >= 4 and n % 2 == 0:
        mesh2 = batch_chunk_mesh(n // 2, 2)
        bb = n                                       # two elements per "b" row
        wb = rng.integers(0, 2**32, (bb, ctx.words32, 4), dtype=np.uint32)
        wb = torch.from_numpy((wb & ctx.valid_mask[None, :, None]).view(np.int32)).to(dev)
        wb[:, :, 0] |= mask                          # every element has matching chunks
        ablk = shard_batch(wb, mesh2)
        prod_b = sharded_mul_batch(ablk, ablk, mesh2)
        bits_b = sharded_decrypt_batch(prod_b, mask, mesh2)
        whole_b = core.mul_chunks(wb, wb)
        ref = shard_batch(whole_b, mesh2)
        _require(torch.equal(prod_b, ref), "2-D batched product != one-device product")
        i = mesh2.coord("b")
        want_bits = core.decrypt_parity(whole_b, mask)[i * 2:(i + 1) * 2].to(torch.int32)
        _require(torch.equal(bits_b, want_bits), "2-D batched decrypt != one-device decrypt")
        rot = sharded_permute_batch(prod_b, perm.benes_plan(), mesh2)
        _require(torch.equal(rot, shard_batch(core.permute_chunks(
            whole_b, torch.tensor(perm.perm, device=dev), ctx.n), mesh2)),
            "2-D batched permute != one-device permute")
        summary["mesh2"] = [n // 2, 2]
        summary["bits2"] = bits_b.tolist()
    return summary
