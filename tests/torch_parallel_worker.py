"""One rank of a gloo job for tests/test_torch_parallel.py (not a test).

    python tests/torch_parallel_worker.py RANK WORLD STORE OUTDIR CASEDIR

Joins a CPU job of WORLD processes through the ``file://`` store STORE, runs
every sharded op of `csgn_tpu_torch.parallel` on its own blocks of the inputs
in CASEDIR/inputs.npz, and writes what it got to OUTDIR/rank<RANK>.npz.  At
world size 4 it also runs the (2, 2) batch x chunk ops, writes a checkpoint
from every rank to CASEDIR/torch4 and loads CASEDIR/jax (written by the JAX
package) onto its mesh; at world size 2 it loads CASEDIR/torch4 onto its
mesh.  Imports torch and csgn_tpu_torch only.
"""

import json
import pathlib
import sys

import numpy as np
import torch

from csgn_tpu_torch import Ciphertext, Context, Permutation, SecretKey, parallel
from csgn_tpu_torch import io as cio
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.parallel import dryrun
from csgn_tpu_torch.pipeline import mul_chain_sharded, mul_chain_sharded_decrypt


def main(rank: int, world: int, store: str, outdir: str, casedir: str) -> None:
    parallel.initialize(f"file://{store}", world, rank, device="cpu")
    case = pathlib.Path(casedir)
    z = np.load(case / "inputs.npz")
    meta = json.loads((case / "meta.json").read_text())
    ctx = Context(meta["n"], meta["d"])
    sk = SecretKey(ctx, z["key"], device="cpu")
    mesh = parallel.chunk_mesh(world)
    me = mesh.coord("c")
    res = {}

    def blocks(words, parts=world, i=me):
        c = words.shape[-1] // parts
        return words_from_numpy(np.ascontiguousarray(words[..., i * c:(i + 1) * c]), "cpu")

    a, b = blocks(z["a"]), blocks(z["b"])
    m = sk.mask_words
    bits = torch.from_numpy(z["bits"])
    bl = len(bits) // world
    res["encrypt"] = parallel.sharded_encrypt_bits(
        meta["seed"], bits[me * bl:(me + 1) * bl], *sk.encrypt_operands, ctx.n, ctx.d, mesh)
    res["encrypt_invariant"] = parallel.sharded_encrypt_bits_invariant(
        meta["seed"], bits[me * bl:(me + 1) * bl], *sk.encrypt_operands, ctx.n, ctx.d, mesh)
    res["allgather"] = parallel.sharded_mul_allgather(a, b, mesh)
    res["ring"] = parallel.sharded_mul_ring(a, b, mesh)
    res["broadcast"] = parallel.sharded_mul_broadcast(a, words_from_numpy(z["b3"], "cpu"), mesh)
    res["mul_decrypt"], parity = parallel.sharded_mul_decrypt(a, b, m, mesh)
    res["mul_decrypt_parity"] = parity.reshape(1)
    res["decrypt_parity"] = parallel.sharded_decrypt_parity(res["allgather"], m, mesh).reshape(1)
    plan = Permutation(z["perm"]).benes_plan()
    res["permute"] = parallel.sharded_permute(res["allgather"], plan, mesh)
    cts = [Ciphertext(a, ctx)] + [Ciphertext(words_from_numpy(z[k], "cpu"), ctx)
                                  for k in ("b", "b3")]
    res["chain"] = mul_chain_sharded(cts, mesh).wt
    chain, p = mul_chain_sharded_decrypt(cts, sk, mesh)
    res["chain_decrypt"], res["chain_decrypt_parity"] = chain.wt, torch.tensor([int(p)])
    padded = parallel.shard_ciphertext(Ciphertext(words_from_numpy(z["odd"], "cpu"), ctx), mesh)
    res["shard_odd"] = padded.wt

    if world == 4:
        mesh2 = parallel.batch_chunk_mesh(2, 2)
        wb = words_from_numpy(z["wb"], "cpu")
        blk = parallel.shard_batch(wb, mesh2)
        res["mul_batch"] = parallel.sharded_mul_batch(blk, blk, mesh2)
        res["decrypt_batch"] = parallel.sharded_decrypt_batch(res["mul_batch"], m, mesh2)
        res["permute_batch"] = parallel.sharded_permute_batch(res["mul_batch"], plan, mesh2)
        res["mesh2_coord"] = torch.tensor([mesh2.coord("b"), mesh2.coord("c")])
        cio.save_state_sharded(case / "torch4", {"prod": Ciphertext(res["allgather"], ctx),
                                                 "sk": sk}, mesh)
        res["load_jax"] = cio.load_state_sharded(case / "jax", mesh=mesh)["prod"].wt
    if world == 2:
        res["load_torch4"] = cio.load_state_sharded(case / "torch4", mesh=mesh)["prod"].wt

    summary = dryrun.run(workdir=outdir)
    res["dryrun_parity"] = torch.tensor([summary["parity"]])
    arrays = {k: (words_to_numpy(v) if v.dtype == torch.int32 and v.dim() >= 2 else v.numpy())
              for k, v in res.items()}
    np.savez(pathlib.Path(outdir) / f"rank{rank}.npz", **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
