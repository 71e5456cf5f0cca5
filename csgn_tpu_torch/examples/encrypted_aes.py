"""AES-128 under homomorphic encryption — the published suite's flagship.

The JAX package's examples/encrypted_aes.py on the port.  A client
encrypts an AES key AND a plaintext block bit by bit (one batched encrypt of
256 bits); an untrusted evaluator runs the FULL AES-128 circuit (~229k
gates, 51,200 ANDs — `models.aes.aes128`) over the ciphertexts without ever
holding the key.  The scheme's multiplication growth is superlinear, so the
evaluator builds the growth-free `CtExpr` DAG (`eval_expr`); the key holder
then decrypts all 128 output bits from the 256 fresh input leaves
(`SecretKey.decrypt_circuits`: one batched leaf decrypt, one host fold).

The result is checked against the FIPS-197 Appendix C.1 vector: the block
computed under encryption must be 69c4e0d86a7b0430d8cdb78070b4c55a.

Run: python -m csgn_tpu_torch.examples.encrypted_aes [--n 95] [--d 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from csgn_tpu_torch import Context, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.models.aes import aes128
from csgn_tpu_torch.models.netlist import bits_from_bytes, bytes_from_bits, eval_expr


def main(n: int = 95, d: int = 4, seed: int = 0xAE5, device=None) -> dict:
    dev = resolve_device(device)
    aes_key = bytes(range(16))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    expect = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")  # FIPS-197 C.1

    t0 = time.time()
    nl = aes128()
    t_build = time.time() - t0

    ctx = Context(n, d)
    k_key, k_one, k_enc = rng.split(rng.key(seed), 3)
    sk = SecretKey.generate(ctx, k_key, dev)
    one = sk.encrypt(1, k_one)

    # Client: encrypt every key/plaintext bit, each under its own key.
    ks = rng.split(k_enc, 256)
    enc_key = [sk.encrypt(b, ks[i]) for i, b in enumerate(bits_from_bytes(aes_key))]
    enc_pt = [sk.encrypt(b, ks[128 + i]) for i, b in enumerate(bits_from_bytes(block))]

    # --- untrusted evaluator: no key from here on ---------------------------
    t0 = time.time()
    (outs,) = eval_expr(nl, [enc_key, enc_pt], one)
    t_eval = time.time() - t0

    # --- key holder: batched leaf decrypts + one shared DAG fold ------------
    t0 = time.time()
    out_bits = [int(v) for v in sk.decrypt_circuits(outs)]
    t_dec = time.time() - t0

    got = bytes_from_bits(out_bits)
    if got != expect:
        raise RuntimeError(f"AES-128 under encryption gave {got.hex()}, not {expect.hex()}")
    return {
        "ciphertext": got.hex(),
        "gates": len(nl.gates),
        "ands": nl.and_count,
        "build_s": round(t_build, 2),
        "eval_s": round(t_eval, 2),
        "decrypt_s": round(t_dec, 2),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=95)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA "
                                                   "device)")
    args = ap.parse_args()
    out = main(n=args.n, d=args.d, device=args.device)
    print(
        f"AES-128(FIPS C.1) homomorphically -> {out['ciphertext']}  "
        f"({out['gates']} gates / {out['ands']} ANDs; build {out['build_s']}s, "
        f"eval {out['eval_s']}s, decrypt {out['decrypt_s']}s)"
    )
