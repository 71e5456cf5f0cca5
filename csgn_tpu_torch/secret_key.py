"""Secret key: encryption, decryption and the fused multiply + decrypt.

Counterpart of `csgn_tpu.secret_key.SecretKey` (reference
`certFHE::SecretKey`, src/SecretKey.{h,cpp}).  The key is d distinct bit
positions in [0, n) plus the packed mask ``[W]``; a chunk decrypts by the
eq-all ``(chunk & mask) == mask`` over its words, then a parity across
chunks.  The index table, the mask and the context's valid mask live on the
key's device, where the kernels read them.

Randomness is explicit: `generate` takes a `torch.Generator`, and encryption
takes an integer seed for the counter engine (threefry2x32 on global
counters, `ops.encrypt_kernels`).  That engine's bits are defined
independently of the backend, so the same (key, seed, bits) encrypt to the
same words here and in the JAX package (`engine="counter"`).
"""

from __future__ import annotations

import numpy as np
import torch

from csgn_tpu_torch import layout
from csgn_tpu_torch.ciphertext import Ciphertext
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.ops import core, dispatch
from csgn_tpu_torch.ops.encrypt_kernels import encrypt_bits_counter
from csgn_tpu_torch.plaintext import Plaintext
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["SecretKey"]


class SecretKey:
    """d secret bit positions + packed mask on a device; encrypt/decrypt."""

    __slots__ = ("ctx", "indices", "device", "_mask", "_mask_t", "_idx_t", "_valid_t")

    def __init__(self, ctx: Context, indices: np.ndarray, device="cpu"):
        indices = np.asarray(indices, dtype=np.int32)
        if indices.shape != (ctx.d,):
            raise ValueError(f"expected {ctx.d} key indices, got shape {indices.shape}")
        if len(np.unique(indices)) != ctx.d:
            raise ValueError("key indices must be distinct")
        if indices.min() < 0 or indices.max() >= ctx.n:
            raise ValueError("key indices out of range")
        self.ctx = ctx
        self.indices = indices
        self.indices.setflags(write=False)
        self.device = torch.device(device)
        self._mask = layout.bit_positions_to_mask(indices, ctx.n)
        self._mask_t = layout.words_from_numpy(self._mask, self.device)
        self._idx_t = torch.from_numpy(indices.copy()).to(self.device)
        self._valid_t = layout.words_from_numpy(ctx.valid_mask, self.device)

    # -- constructors -------------------------------------------------------

    @classmethod
    def generate(cls, ctx: Context, generator: torch.Generator, device="cpu") -> "SecretKey":
        """Sample a fresh key (uniform d-subset of [0, n), random order)."""
        return cls(ctx, core.keygen(ctx.n, ctx.d, generator).numpy(), device)

    # -- properties ---------------------------------------------------------

    @property
    def mask(self) -> np.ndarray:
        """Packed indicator of the secret positions: uint32[W], popcount d."""
        return self._mask

    @property
    def mask_words(self) -> torch.Tensor:
        """The mask as int32[W] on the key's device (the kernels' form)."""
        return self._mask_t

    @property
    def encrypt_operands(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(key indices int32[d], mask int32[W], valid mask int32[W])`` on
        the key's device: the key-side arguments of `encrypt_bits_counter`."""
        return self._idx_t, self._mask_t, self._valid_t

    def size(self) -> int:
        """Reference byte accounting (src/SecretKey.cpp:268-276): 144 B at d=16."""
        return 8 + 8 + 8 * self.ctx.d

    # -- encryption ---------------------------------------------------------

    def encrypt(self, plaintext, seed: int) -> Ciphertext:
        """Encrypt one bit into a fresh single-chunk ciphertext."""
        bits = torch.tensor([int(plaintext) & 1], dtype=torch.int32, device=self.device)
        return Ciphertext(self.encrypt_batch(bits, seed), self.ctx)

    def encrypt_batch(self, bits, seed: int) -> torch.Tensor:
        """Encrypt bits[batch] -> fresh chunk words int32[W, batch].

        Counter engine: the words depend only on (key, seed, bit, batch
        index), on any device and for any batch size.  `bits` may be a
        tensor, an array or a list; it is moved to the key's device.
        """
        bits = torch.as_tensor(bits, device=self.device)
        if bits.dim() != 1:
            raise ValueError(f"encrypt_batch expects bits[batch], got shape {tuple(bits.shape)}")
        batch = int(bits.shape[0])
        with op_metrics().record(
            "key.encrypt", chunks_out=batch, bytes_moved=self.ctx.chunk_count_bytes(batch),
        ):
            return encrypt_bits_counter(seed, bits, *self.encrypt_operands)

    # -- decryption ---------------------------------------------------------

    def _check(self, ciphertext: Ciphertext) -> None:
        if ciphertext.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")

    def decrypt(self, ciphertext: Ciphertext) -> Plaintext:
        """Decrypt any-length ciphertext: parity of per-chunk ANDs."""
        self._check(ciphertext)
        with op_metrics().record(
            "key.decrypt", chunks_in=ciphertext.chunks,
            bytes_moved=self.ctx.chunk_count_bytes(ciphertext.chunks),
        ):
            return Plaintext(int(dispatch.decrypt_parity(ciphertext.wt, self._mask_t)))

    def decrypt_batch(self, words: torch.Tensor) -> torch.Tensor:
        """Decrypt fresh single-chunk ciphertexts ``int32[W, batch]`` -> bits
        int32[batch] (the parity of one chunk is its match bit)."""
        w = self.ctx.words32
        if not isinstance(words, torch.Tensor):
            raise TypeError(f"decrypt_batch expects a torch.Tensor, got {type(words).__name__}")
        if words.dim() == 3:
            raise NotImplementedError(
                "decrypt_batch of grown [batch, W, chunks] payloads is not ported yet"
            )
        if words.dim() != 2 or words.shape[0] != w:
            raise ValueError(
                f"decrypt_batch fresh chunks must be [W={w}, batch] "
                f"(word-major; a transposed [batch, W] input would silently "
                f"decrypt garbage), got {tuple(words.shape)}"
            )
        with op_metrics().record(
            "key.decrypt_batch", chunks_in=words.shape[-1], bytes_moved=words.numel() * 4,
        ):
            return dispatch.chunk_matches(words, self._mask_t)

    def mul_and_decrypt(self, c1: Ciphertext, c2: Ciphertext) -> tuple[Ciphertext, Plaintext]:
        """Fused multiply + decrypt: ``(c1 * c2, Dec(c1 * c2))`` in one pass.

        The product is written once and its decrypt count is taken in the
        same kernel, so the decrypt's full re-read of the product is gone
        (csrc/mul.cu).  Bit-exact to ``self.decrypt(c1 * c2)``; the product
        is canonical, like ``*``.
        """
        self._check(c1)
        self._check(c2)
        t1, t2 = c1.chunks, c2.chunks
        with op_metrics().record(
            "key.mul_and_decrypt", chunks_in=t1 + t2, chunks_out=t1 * t2,
            bytes_moved=self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            out, parity = dispatch.mul_decrypt(c1.wt, c2.wt, self._mask_t)
            return Ciphertext(out, self.ctx), Plaintext(int(parity))

    def decrypt_product(self, cts: list[Ciphertext]) -> Plaintext:
        """Decrypt a product WITHOUT materializing it: Dec(∏ cᵢ) = ∧ Dec(cᵢ)."""
        acc = 1
        for ct in cts:
            acc &= int(self.decrypt(ct))
            if acc == 0:
                break
        return Plaintext(acc)

    def recrypt(self, ciphertext: Ciphertext, seed: int) -> Ciphertext:
        """Key-side re-encryption: decrypt, then a fresh 1-chunk ciphertext
        of the same bit (the growth reset of this bounded scheme)."""
        return self.encrypt(int(self.decrypt(ciphertext)), seed)

    def __repr__(self) -> str:
        return f"SecretKey(ctx={self.ctx}, d={self.ctx.d}, device={self.device})"

    def __str__(self) -> str:
        # Space-separated index list, as the reference prints it
        # (src/SecretKey.cpp:22-29).
        return " ".join(str(int(x)) for x in self.indices) + " "
