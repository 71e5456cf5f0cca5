"""Multi-device SPMD layer on `torch.distributed`: meshes of ranks and the
collective homomorphic ops.

Counterpart of `csgn_tpu.parallel`, whose `shard_map` bodies become one
program per rank: each rank holds its own block of a chunk-sharded (or
batch-sharded) ciphertext, calls the ops with it and gets its own block back.
The three collectives of the JAX layer — the all-gather of b, the ring
`ppermute` and the one-word `psum` of the match count — are
`all_gather_into_tensor`, `batch_isend_irecv` and an int64 `all_reduce`,
over NCCL between CUDA devices and gloo between CPU processes.  Each rank's
own work is the port's CUDA kernels (K1-K4, K8 and the multiply's modes).
"""

from csgn_tpu_torch.parallel.batch_ops import (
    batch_chunk_mesh,
    shard_batch,
    sharded_decrypt_batch,
    sharded_mul_batch,
    sharded_permute_batch,
)
from csgn_tpu_torch.parallel.mesh import Mesh, chunk_mesh, make_mesh
from csgn_tpu_torch.parallel.multihost import (
    global_chunk_mesh,
    initialize,
    pad_chunks_to,
    shard_ciphertext,
)
from csgn_tpu_torch.parallel.ops import (
    sharded_decrypt_parity,
    sharded_encrypt_bits,
    sharded_encrypt_bits_invariant,
    sharded_mul_allgather,
    sharded_mul_broadcast,
    sharded_mul_decrypt,
    sharded_mul_ring,
    sharded_permute,
)

__all__ = [
    "make_mesh",
    "chunk_mesh",
    "batch_chunk_mesh",
    "shard_batch",
    "sharded_mul_batch",
    "sharded_decrypt_batch",
    "sharded_permute_batch",
    "global_chunk_mesh",
    "initialize",
    "pad_chunks_to",
    "shard_ciphertext",
    "sharded_mul_allgather",
    "sharded_mul_broadcast",
    "sharded_mul_decrypt",
    "sharded_mul_ring",
    "sharded_encrypt_bits_invariant",
    "sharded_decrypt_parity",
    "sharded_encrypt_bits",
    "sharded_permute",
    "Mesh",
]
