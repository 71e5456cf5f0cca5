"""csgn_tpu_torch — the CSGN/CertSGN bounded homomorphic encryption scheme in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `csgn_tpu` (JAX + Pallas), which stays the reference: the same key
indices, seeds and ciphertext words give bit-equal words and parities, and
`rng` is the counterpart of `jax.random` (``rng.key(s)`` for
``jax.random.key(s)``), so the same keys draw the same secret keys,
permutations and ciphertext words.  The
data contract is unchanged — word-major ``[W, C]`` MSB-first 32-bit words,
held as ``torch.int32`` (a bit-identical view of the uint32 words).

This package imports torch and numpy only, never jax or csgn_tpu.  Tensors on
the CPU run the plain torch versions of the kernels; tensors on a CUDA device
run the kernels in ``csrc/``, built by nvcc at first use.  Entry points put
their objects on the current CUDA device unless given ``device="cpu"`` (the
CLI: ``--device cpu``), and raise where there is no card.  Checkpoints
(`csgn_tpu_torch.io`) use the JAX package's file format.
"""

from csgn_tpu_torch import models, rng
from csgn_tpu_torch.batch import CiphertextBatch
from csgn_tpu_torch.ciphertext import Ciphertext, set_eager_order
from csgn_tpu_torch.circuit import CtExpr, lift
from csgn_tpu_torch.config import RunConfig
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.plaintext import Plaintext
from csgn_tpu_torch.secret_key import SecretKey
from csgn_tpu_torch.serve import BatchExecutor, ServeFuture

__version__ = "0.1.0"

__all__ = [
    "Context", "Plaintext", "SecretKey", "Ciphertext", "CiphertextBatch", "set_eager_order",
    "Permutation",
    "CtExpr", "lift", "RunConfig", "BatchExecutor", "ServeFuture", "models", "rng",
    "__version__",
]
