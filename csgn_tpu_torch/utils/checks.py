"""Runtime validation: canonical ciphertexts and consistent keys.

Counterpart of `csgn_tpu.utils.checks`.  The reference ships real memory
bugs with no sanitizers (use-after-free in operator=, SURVEY.md §2b.1;
out-of-bounds bitlen write for n%64==0); what remains worth checking is
*data* validity:

  * canonical form: no set bits at positions >= n (padding words clean);
  * key validity: d distinct in-range indices, mask popcount == d.

`validate_ciphertext` / `validate_key` are host-side.  `checked_decrypt`
replaces the JAX package's ``checkify`` pattern: one test on the device,
one synchronization, and a ``ValueError`` on a violation.
"""

from __future__ import annotations

import numpy as np
import torch

from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.layout import words_to_numpy
from csgn_tpu_torch.ops import dispatch
from csgn_tpu_torch.secret_key import SecretKey

__all__ = ["validate_ciphertext", "validate_key", "checked_decrypt"]


def validate_ciphertext(ct: Ciphertext) -> None:
    """Raise ValueError on any canonical-form violation (host-side).  The
    word type and count need no check here: `Ciphertext` enforces them."""
    bad = words_to_numpy(ct.wt) & ~ct.ctx.valid_mask[:, None]
    if bad.any():
        w, c = np.argwhere(bad)[0]
        raise ValueError(
            f"non-canonical ciphertext: set bit beyond n={ct.ctx.n} "
            f"in chunk {c}, word {w} (value {bad[w, c]:#010x})"
        )


def validate_key(sk: SecretKey) -> None:
    """Raise ValueError if the key/mask pair is inconsistent (host-side)."""
    d = sk.ctx.d
    if len(np.unique(sk.indices)) != d:
        raise ValueError("key indices not distinct")
    pop = int(sum(int(x).bit_count() for x in sk.mask))
    if pop != d:
        raise ValueError(f"mask popcount {pop} != d {d}")


def checked_decrypt(words: torch.Tensor, mask: torch.Tensor, valid_mask: torch.Tensor) -> int:
    """Decrypt int32 ``[W, C]`` words to their parity, raising ValueError if
    any bit beyond n is set.  The canonical test and the decrypt run on the
    words' device; both results come back in one synchronization."""
    bad = (words & ~valid_mask[:, None]).any()
    parity = dispatch.decrypt_parity(words, mask)
    bad_h, parity_h = torch.stack([bad.to(torch.int64), parity.to(torch.int64)]).tolist()
    if bad_h:
        raise ValueError("non-canonical ciphertext: bits set beyond n")
    return int(parity_h)
