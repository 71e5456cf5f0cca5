"""Encrypted 64-bit addition from a standard Bristol-Fashion circuit file.

The JAX package's examples/bristol_adder.py on the port.  Loads
``tests/circuits/adder64.txt`` (the published suite's interface: two 64-bit
little-endian inputs -> one 64-bit sum), encrypts two integers bit by bit
(one batched encrypt), evaluates the circuit homomorphically with ZERO
device growth (`eval_expr` builds +/* DAGs: the materialized top carry would
exceed 2^60 chunks, reference growth semantics src/Ciphertext.cpp:107-163),
and decrypts the sum key-side: the 64 output DAGs share the 128 input
leaves, so `SecretKey.decrypt_circuits` decrypts the leaves in one batched
launch and folds every DAG on the host.

Run: python -m csgn_tpu_torch.examples.bristol_adder [--x 123456789] [--y 987654321] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

from csgn_tpu_torch import Context, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.models.netlist import Netlist, eval_expr, eval_plain

CIRCUIT = pathlib.Path(__file__).resolve().parents[2] / "tests" / "circuits" / "adder64.txt"


def main(x: int = 123456789, y: int = 987654321, n: int = 95, d: int = 4, seed: int = 0,
         device=None) -> dict:
    dev = resolve_device(device)
    nl = Netlist.parse(CIRCUIT.read_text())
    if nl.input_sizes != (64, 64) or nl.output_sizes != (64,):
        raise ValueError(f"{CIRCUIT.name}: interface {nl.input_sizes} -> {nl.output_sizes}")

    ctx = Context(n, d)
    keys = rng.split(rng.key(seed), 130)
    sk = SecretKey.generate(ctx, keys[0], dev)
    one = sk.encrypt(1, keys[1])

    bits_x = [(x >> i) & 1 for i in range(64)]
    bits_y = [(y >> i) & 1 for i in range(64)]
    enc_x = [sk.encrypt(b, keys[2 + i]) for i, b in enumerate(bits_x)]
    enc_y = [sk.encrypt(b, keys[66 + i]) for i, b in enumerate(bits_y)]

    (expr_out,) = eval_expr(nl, [enc_x, enc_y], one)
    want = (x + y) % 2**64
    # Plain-oracle check of the whole circuit, then the encrypted sum.
    (plain,) = eval_plain(nl, [bits_x, bits_y])
    plain_val = sum(b << i for i, b in enumerate(plain))
    if plain_val != want:
        raise RuntimeError(f"plain circuit gives {plain_val}, not {want}")

    out_bits = [int(v) for v in sk.decrypt_circuits(expr_out)]
    got = sum(b << i for i, b in enumerate(out_bits))
    if got != want:
        raise RuntimeError(f"encrypted sum decrypts to {got}, not {want}")

    out = {
        "x": x, "y": y, "sum": want,
        "gates": len(nl.gates), "and_gates": nl.and_count,
        "materialized_growth_max": max(nl.growth()),
        "decrypted_bits_checked": 64,
    }
    print(f"adder64: {x} + {y} = {want}  "
          f"({len(nl.gates)} gates, {nl.and_count} ANDs, "
          f"materialized growth would be {out['materialized_growth_max']:.2e} chunks; "
          f"all 64 output bits decrypted via one batched leaf decrypt)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--x", type=int, default=123456789)
    ap.add_argument("--y", type=int, default=987654321)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    main(args.x, args.y, device=args.device)
