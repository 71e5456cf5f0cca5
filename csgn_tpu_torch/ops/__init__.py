"""Ops of the port: plain torch oracles (`core`), the CUDA kernels with their
plain versions (`kernels`, `encrypt_kernels`, `benes_kernels`), the Beneš
routing and its plain versions (`permute_benes`), their build (`_build`) and
the dispatch the public classes call (`dispatch`).  Importing builds nothing;
the kernels build at first launch.  The plain oracles are re-exported as
the JAX package's `csgn_tpu.ops` re-exports its jnp ones (its `encrypt_bits`
is `encrypt_kernels.encrypt_bits_threefry` here)."""

from csgn_tpu_torch.ops.core import (
    add_chunks,
    chunk_matches,
    decrypt_parity,
    keygen,
    mul_chunks,
    permute_chunks,
)

__all__ = [
    "add_chunks",
    "chunk_matches",
    "decrypt_parity",
    "keygen",
    "mul_chunks",
    "permute_chunks",
]
