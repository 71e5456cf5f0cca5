"""Encrypt-invariant statistics of the Philox engine.

Counterpart of the JAX package's tools/enc_stats.py, which checks the TPU's
hardware-PRNG engine at Context(4095, 32) over 2^20 columns.  The raw stream
comes from `philox_streams` (K13), the Philox engine's own rows, and the
production output (`encrypt_bits_philox`, K7) must equal the fix-up applied
to them (clone fidelity); after that the streams are trusted to carry the
true forced-index choices r and per-position bits.  Checks, with the JAX
tool's thresholds:

  1. chi-square of r over [0, d) (df = d - 1) below its p = .001 point
     (61.1 at df = 31);
  2. per-secret-position set-bit z-scores of zero-encryptions below 5;
  3. no adjacent duplicate chunks (stream collisions);
  4. no column of seed S, shifted by one 8192-column window, equal to seed
     S + 1's (the collision mode of per-block seeding);
  5. the worst chi-square of r over the first eight 8192-column windows,
     below the same point.

Run on the card (the default) or on the CPU:

    python -m csgn_tpu_torch.tools.enc_stats [--n 4095 --d 32 --batch 1048576]
                                             [--seed 424242] [--device cpu]

It prints the figures as JSON and exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.ops import encrypt_kernels as ek
from csgn_tpu_torch.secret_key import SecretKey

__all__ = ["run", "chi2_threshold", "WINDOW"]

WINDOW = 8192
# Chi-square points at p = .001 (tables); other df use Wilson-Hilferty.
_CHI2_P001 = {3: 16.27, 15: 37.70, 31: 61.10}


def chi2_threshold(df: int) -> float:
    """The chi-square value exceeded with probability .001 at `df`."""
    if df in _CHI2_P001:
        return _CHI2_P001[df]
    z = 3.090232  # the normal's .999 point
    return df * (1 - 2 / (9 * df) + z * math.sqrt(2 / (9 * df))) ** 3


def _chi2(r: torch.Tensor, d: int) -> tuple[float, list[int]]:
    hist = torch.bincount(r, minlength=d).cpu().numpy()
    exp = r.numel() / d
    return float(((hist - exp) ** 2 / exp).sum()), hist.tolist()


def run(ctx: Context, batch: int, seed: int, device=None, key_seed: int = 3) -> dict:
    """Every check at `ctx` over `batch` columns of zero-encryptions under a
    key drawn from `key_seed`; returns the figures, ``failed`` (the names of
    the checks that failed) and ``ok``."""
    device = resolve_device(device)
    w, d = ctx.words32, ctx.d
    sk = SecretKey.generate(ctx, torch.Generator().manual_seed(key_seed), device)
    key_idx, mask, valid = sk.encrypt_operands
    bits0 = torch.zeros(batch, dtype=torch.int32, device=device)

    prod = ek.encrypt_bits_philox(seed, bits0, key_idx, mask, valid)
    streams = ek.philox_streams(seed, batch, w + 2, device)
    stream64 = streams.to(torch.int64) & 0xFFFFFFFF
    rec = ek.derive_words(stream64, bits0, key_idx, mask, valid)
    fidelity = bool(torch.equal(prod, rec))
    del rec

    r = stream64[w] % d
    del stream64, streams
    chi2, hist = _chi2(r, d)
    limit = chi2_threshold(d - 1)

    pos = sk.indices.astype(np.int64)
    word = torch.from_numpy(pos // 32).to(device)
    bit = torch.from_numpy(np.left_shift(1, 31 - pos % 32).astype(np.uint32).view(np.int32))
    counts = ((prod[word] & bit.to(device)[:, None]) != 0).sum(dim=1).cpu().numpy()
    z = (counts - batch / 2) / math.sqrt(batch * 0.25)

    dups = int((prod[:, 1:] == prod[:, :-1]).all(dim=0).sum())
    prod2 = ek.encrypt_bits_philox(seed + 1, bits0, key_idx, mask, valid)
    cross = int((prod[:, WINDOW:] == prod2[:, :-WINDOW]).all(dim=0).sum()) \
        if batch > WINDOW else 0
    del prod2
    windows = [_chi2(r[k * WINDOW:(k + 1) * WINDOW], d)[0]
               for k in range(min(8, batch // WINDOW))]
    worst = max(windows, default=0.0)

    out = {
        "n": ctx.n, "d": d, "batch": batch, "seed": seed, "device": str(device),
        "clone_fidelity": fidelity, "chi2": chi2, "chi2_df": d - 1, "chi2_limit": limit,
        "hist": hist, "z_min": float(z.min()), "z_max": float(z.max()),
        "z_abs_max": float(np.abs(z).max()), "adjacent_duplicates": dups,
        "cross_seed_shifted_equal": cross, "window": WINDOW, "windows": len(windows),
        "window_chi2_worst": worst,
    }
    checks = {
        "clone_fidelity": fidelity,
        "chi2": chi2 < limit,
        "z": out["z_abs_max"] < 5.0,
        "adjacent_duplicates": dups == 0,
        "cross_seed_shifted_equal": cross == 0,
        "window_chi2_worst": worst < limit,
    }
    out["failed"] = [k for k, ok in checks.items() if not ok]
    out["ok"] = not out["failed"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=4095)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--batch", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=424242)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    res = run(Context(args.n, args.d), args.batch, args.seed, args.device)
    print(json.dumps(res))
    print("ENC STATS OK" if res["ok"] else f"ENC STATS FAILED: {res['failed']}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
