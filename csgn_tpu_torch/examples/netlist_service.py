"""Private-comparison service: netlists and the serving executor together.

The JAX package's examples/netlist_service.py on the port.  A sealed-bid
setting: each client encrypts its bid bit by bit; an untrusted server
evaluates a Bristol-format comparator netlist (`comparator_gt`) over every
encrypted bid against an encrypted reserve price — with NO key and NO
device growth (`eval_expr` builds +/* DAGs); the auctioneer decrypts every
bid's one-output DAG, all of them sharing the reserve's leaves, with one
`SecretKey.decrypt_circuits` call.

The serving layer does the encryption fleet: `BatchExecutor` groups all
bids × width bit-encrypts into ONE batched encrypt launch instead of one
per bit.

Run: python -m csgn_tpu_torch.examples.netlist_service [--bidders 8] [--width 16] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from csgn_tpu_torch import BatchExecutor, Context, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.models import comparator_gt
from csgn_tpu_torch.models.netlist import eval_expr, eval_plain


def main(bidders: int = 8, width: int = 16, n: int = 95, d: int = 4, seed: int = 0,
         device=None) -> dict:
    dev = resolve_device(device)
    ctx = Context(n, d)
    k_key, k_enc, k_bids = rng.split(rng.key(seed), 3)
    sk = SecretKey.generate(ctx, k_key, dev)

    draws = np.random.default_rng(int(rng.randint(k_bids, (), 0, 2**31 - 1)))
    bids = draws.integers(0, 1 << width, size=bidders)
    reserve = int(draws.integers(0, 1 << width))

    def bits(x: int) -> list[int]:
        return [(x >> i) & 1 for i in range(width)]

    # --- clients + auctioneer: encrypt every bid bit in ONE batched launch
    ex = BatchExecutor(sk, rng=k_enc)
    bid_futs = [[ex.submit_encrypt(b) for b in bits(int(v))] for v in bids]
    reserve_futs = [ex.submit_encrypt(b) for b in bits(reserve)]
    one_fut = ex.submit_encrypt(1)
    ex.flush()
    if ex.stats["group_dispatches"] != 1:
        raise RuntimeError(f"the encrypts took {ex.stats['group_dispatches']} group launches")
    enc_bids = [[f.result() for f in row] for row in bid_futs]
    enc_reserve = [f.result() for f in reserve_futs]
    one = one_fut.result()

    # --- untrusted server: the comparator netlist per bid (no key, no growth)
    netlist = comparator_gt(width)
    exprs = [eval_expr(netlist, [eb, enc_reserve], one)[0][0] for eb in enc_bids]

    # --- auctioneer: one batched leaf decrypt for the whole auction
    qualified = [int(v) for v in sk.decrypt_circuits(exprs)]

    want = [int(v > reserve) for v in bids]
    plain = [eval_plain(netlist, [bits(int(v)), bits(reserve)])[0][0] for v in bids]
    if qualified != want or plain != want:
        raise RuntimeError(f"bids {bids.tolist()} against {reserve}: decrypted {qualified}, "
                           f"plain circuit {plain}, expected {want}")
    return {
        "bidders": bidders,
        "reserve": reserve,
        "qualified": qualified,
        "encrypt_dispatches": ex.stats["group_dispatches"],
        "and_gates": netlist.and_count,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--bidders", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--n", type=int, default=95)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    print(main(args.bidders, args.width, args.n, args.d, device=args.device))
