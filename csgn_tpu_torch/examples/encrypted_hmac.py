"""HMAC-SHA256 with an ENCRYPTED key — circuit composition across blocks.

The JAX package's examples/encrypted_hmac.py on the port.  The MAC key
lives only as CSGN ciphertexts; the evaluator composes FOUR SHA-256
compressions (inner: (K ^ ipad) || message, outer: (K ^ opad) ||
inner-digest) into one `CtExpr` DAG — the output wires of one compression
feed the next as expression leaves, and public bits (padding, the message,
the IV) enter as public constant encryptions.  The key holder decrypts the
256 tag bits, which must equal ``hmac.new(key, msg, sha256)``.

~500k-node DAG, folded key-side in one shared-memo pass
(`SecretKey.decrypt_circuits`).

Run: python -m csgn_tpu_torch.examples.encrypted_hmac [--n 95] [--d 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import hmac as hmac_mod
import struct
import time

from csgn_tpu_torch import Context, SecretKey, rng
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.circuit import lift
from csgn_tpu_torch.models.netlist import bits_from_bytes, bytes_from_bits, eval_expr
from csgn_tpu_torch.models.sha256 import SHA256_IV, sha256_compress


def main(n: int = 95, d: int = 4, seed: int = 0x11AC, device=None) -> dict:
    dev = resolve_device(device)
    mac_key = bytes(range(32))                     # secret: encrypted below
    msg = b"attested by csgn_tpu"                  # public
    expect = hmac_mod.new(mac_key, msg, "sha256").digest()

    nl = sha256_compress()
    ctx = Context(n, d)
    k_key, k_one, k_enc = rng.split(rng.key(seed), 3)
    sk = SecretKey.generate(ctx, k_key, dev)
    one = sk.encrypt(1, k_one)

    # Client: encrypt the 256 MAC-key bits, each under its own key.
    ks = rng.split(k_enc, 256)
    enc_key = [sk.encrypt(b, ks[i]) for i, b in enumerate(bits_from_bytes(mac_key))]

    # --- untrusted evaluator: no key from here on ---------------------------
    t0 = time.time()
    one_e = lift(one)
    zero_e = one_e + one_e                         # public encryption of 0

    def const_bits(bs: bytes) -> list:
        return [one_e if b else zero_e for b in bits_from_bytes(bs)]

    iv_bits = const_bits(b"".join(struct.pack(">I", h) for h in SHA256_IV))

    def keypad_block(pad_byte: int) -> list:
        """(K || 0*32) ^ pad_byte as 512 expression bits: encrypted key bits
        XOR a public constant flip (ct + one), padding bytes fully public."""
        bits = []
        for i, ct in enumerate(enc_key):
            flip = (pad_byte >> (i % 8)) & 1
            bits.append(lift(ct) + one_e if flip else lift(ct))
        bits.extend(const_bits(bytes([pad_byte] * 32)))
        return bits

    def compress(block_bits: list, state_bits: list) -> list:
        (out,) = eval_expr(nl, [block_bits, state_bits], one)
        return out

    def pad_tail(tail_len: int, total_len: int) -> bytes:
        """0x80 + zeros + big-endian bit length: closes a second 64-byte
        block whose first ``tail_len`` bytes the caller supplies."""
        return b"\x80" + b"\x00" * (64 - tail_len - 9) + struct.pack(">Q", 8 * total_len)

    # Inner hash: H((K' ^ ipad) || msg) — 2 compressions.
    state = compress(keypad_block(0x36), iv_bits)
    state = compress(const_bits(msg + pad_tail(len(msg), 64 + len(msg))), state)
    # Outer hash: H((K' ^ opad) || inner_digest) — 2 more; the digest bits
    # are CtExpr wires flowing straight into the next circuit instance.
    tag = compress(keypad_block(0x5C), iv_bits)
    tag = compress(state + const_bits(pad_tail(32, 96)), tag)
    t_eval = time.time() - t0

    # --- key holder: batched leaf decrypts + one shared DAG fold ------------
    t0 = time.time()
    got = bytes_from_bits([int(v) for v in sk.decrypt_circuits(tag)])
    t_dec = time.time() - t0

    if got != expect:
        raise RuntimeError(f"HMAC under encryption gave {got.hex()}, not {expect.hex()}")
    return {
        "tag": got.hex(),
        "compressions": 4,
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
        f"HMAC-SHA256(encrypted key) -> {out['tag']}  "
        f"({out['compressions']} chained compressions; eval {out['eval_s']}s, "
        f"decrypt {out['decrypt_s']}s)"
    )
