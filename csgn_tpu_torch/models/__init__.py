"""Homomorphic circuit layer — the framework's "model" family.

The scheme exposes two gates natively (add = XOR, mul = AND over F2); this
package builds the standard boolean-circuit vocabulary on top (NOT/OR/MUX,
adders, comparators) with chunk-growth accounting, the way a model zoo sits
on top of an NN framework's ops.

Counterpart of `csgn_tpu.models`: the netlist builders and parser are the
same pure Python, so `aes128()`, `sha256_compress()` and the generators here
emit the same gates as the JAX package's.
"""

from csgn_tpu_torch.models.aes import aes128
from csgn_tpu_torch.models.circuits import Gates
from csgn_tpu_torch.models.linear import matvec_f2
from csgn_tpu_torch.models.sha256 import sha256_compress
from csgn_tpu_torch.models.lookup import private_lookup
from csgn_tpu_torch.models.netlist import (
    Netlist,
    adder,
    bits_from_bytes,
    bytes_from_bits,
    comparator_gt,
    equality,
    eval_expr,
    eval_homomorphic,
    eval_homomorphic_batch,
    eval_plain,
    eval_plain_packed,
)

__all__ = [
    "aes128",
    "sha256_compress",
    "Gates",
    "matvec_f2",
    "private_lookup",
    "Netlist",
    "adder",
    "bits_from_bytes",
    "bytes_from_bits",
    "comparator_gt",
    "equality",
    "eval_expr",
    "eval_homomorphic",
    "eval_homomorphic_batch",
    "eval_plain",
    "eval_plain_packed",
]
