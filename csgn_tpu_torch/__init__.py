"""csgn_tpu_torch — the CSGN/CertSGN bounded homomorphic encryption scheme in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `csgn_tpu` (JAX + Pallas), which stays the reference: the same key
indices, seeds and ciphertext words give bit-equal words and parities.  The
data contract is unchanged — word-major ``[W, C]`` MSB-first 32-bit words,
held as ``torch.int32`` (a bit-identical view of the uint32 words).

This package imports torch and numpy only, never jax or csgn_tpu.  Tensors on
the CPU run the plain torch versions of the kernels; tensors on a CUDA device
run the kernels in ``csrc/``, built by nvcc at first use.
"""

from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.plaintext import Plaintext
from csgn_tpu_torch.secret_key import SecretKey

__version__ = "0.1.0"

__all__ = ["Context", "Plaintext", "SecretKey", "Ciphertext", "__version__"]
