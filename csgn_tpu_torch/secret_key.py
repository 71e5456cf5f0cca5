"""Secret key: encryption, decryption, the fused multiply + decrypt, and the
key transform under a permutation.

Counterpart of `csgn_tpu.secret_key.SecretKey` (reference
`certFHE::SecretKey`, src/SecretKey.{h,cpp}).  The key is d distinct bit
positions in [0, n) plus the packed mask ``[W]``; a chunk decrypts by the
eq-all ``(chunk & mask) == mask`` over its words, then a parity across
chunks.  The index table, the mask and the context's valid mask live on the
key's device, where the kernels read them.

Randomness is explicit and the JAX package's: `generate` takes an
`rng.Key` (the counterpart of a `jax.random` key) and draws the indices that
`csgn_tpu.SecretKey.generate` draws from the same key.  Encryption takes an
`rng.Key` or an integer seed, and the argument picks the engine
(`ops.encrypt_kernels`): a key runs the JAX package's default engine,
"threefry" (K14), and returns the words of `csgn_tpu`'s
``encrypt_batch(bits, key)``; an integer seed runs the counter engine (K4,
the JAX package's ``engine="counter"``, the same words too) or, asked for,
the Philox engine (K7), the counterpart of the JAX package's hardware-PRNG
engine.  Keys live on the current CUDA device unless ``device="cpu"`` is
given.
"""

from __future__ import annotations

import numpy as np
import torch

from csgn_tpu_torch import layout
from csgn_tpu_torch._device import resolve_device
from csgn_tpu_torch.batch import CiphertextBatch
from csgn_tpu_torch import ciphertext as ct_mod
from csgn_tpu_torch.ciphertext import Ciphertext, product_tag
from csgn_tpu_torch.circuit import collect_leaves, fold_many, lift, pack_fleet_bits, \
    unpack_fleet_bits
from csgn_tpu_torch.context import Context
from csgn_tpu_torch.ops import core, dispatch
from csgn_tpu_torch.ops.encrypt_kernels import encrypt_bits_counter, encrypt_bits_philox, \
    encrypt_bits_threefry
from csgn_tpu_torch.permutation import Permutation
from csgn_tpu_torch.plaintext import Plaintext
from csgn_tpu_torch.rng import Key
from csgn_tpu_torch.utils.metrics import op_metrics

__all__ = ["SecretKey"]

_ENGINES = {"threefry": encrypt_bits_threefry, "counter": encrypt_bits_counter,
            "philox": encrypt_bits_philox}


def _engine_for(rng, engine: str | None) -> str:
    """The engine an encrypt's randomness selects: an `rng.Key` runs
    "threefry", an integer seed "counter" unless "philox" is asked for; an
    explicit engine that does not fit the argument raises."""
    if engine is not None and engine not in _ENGINES:
        raise ValueError(f"unknown encrypt engine {engine!r}")
    if isinstance(rng, Key):
        if engine not in (None, "threefry"):
            raise ValueError(f"engine {engine!r} takes an integer seed, got an rng.Key")
        return "threefry"
    if isinstance(rng, (bool, np.bool_)) or not isinstance(rng, (int, np.integer)):
        raise TypeError(f"encrypt randomness must be an rng.Key or an integer seed, got "
                        f"{type(rng).__name__}")
    if engine == "threefry":
        raise ValueError("engine 'threefry' takes an rng.Key, got an integer seed")
    return engine or "counter"


class SecretKey:
    """d secret bit positions + packed mask on a device; encrypt/decrypt."""

    __slots__ = ("ctx", "indices", "device", "_mask", "_mask_t", "_idx_t", "_valid_t")

    def __init__(self, ctx: Context, indices: np.ndarray, device=None):
        """Key over `indices` on `device`: None is the current CUDA device (it
        raises where there is none), ``"cpu"`` the CPU."""
        device = resolve_device(device)
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
        self.device = device
        self._mask = layout.bit_positions_to_mask(indices, ctx.n)
        self._mask_t = layout.words_from_numpy(self._mask, self.device)
        self._idx_t = torch.from_numpy(indices.copy()).to(self.device)
        self._valid_t = layout.words_from_numpy(ctx.valid_mask, self.device)

    # -- constructors -------------------------------------------------------

    @classmethod
    def generate(cls, ctx: Context, key: Key, device=None) -> "SecretKey":
        """Sample a fresh key (uniform d-subset of [0, n), random order) from
        an `rng.Key`: the indices `csgn_tpu.SecretKey.generate` draws from
        the same `jax.random` key."""
        if not isinstance(key, Key):
            raise TypeError(f"generate: expected an rng.Key, got {type(key).__name__}")
        return cls(ctx, core.keygen(key, ctx.n, ctx.d).numpy(), device)

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
        the key's device: the key-side arguments of the encrypt engines."""
        return self._idx_t, self._mask_t, self._valid_t

    def size(self) -> int:
        """Reference byte accounting (src/SecretKey.cpp:268-276): 144 B at d=16."""
        return 8 + 8 + 8 * self.ctx.d

    # -- encryption ---------------------------------------------------------

    def encrypt(self, plaintext, rng) -> Ciphertext:
        """Encrypt one bit into a fresh single-chunk ciphertext (`rng`: an
        `rng.Key` or an integer seed, as `encrypt_batch`)."""
        bits = torch.tensor([int(plaintext) & 1], dtype=torch.int32, device=self.device)
        return Ciphertext(self.encrypt_batch(bits, rng), self.ctx)

    def encrypt_batch(self, bits, rng, engine: str | None = None) -> torch.Tensor:
        """Encrypt bits[batch] -> fresh chunk words int32[W, batch].

        The engine follows `rng` (an explicit `engine` that does not fit it
        raises):
        an `rng.Key` runs "threefry" (K14), the JAX package's default engine:
        the words of `csgn_tpu`'s ``encrypt_batch(bits, key)`` for the same
        `jax.random` key;
        an integer seed runs "counter" (K4), threefry2x32 on global counters:
        the words depend only on (key, seed, bit, batch index), on any device
        and for any batch size, and equal the JAX package's
        ``encrypt_batch(..., engine="counter")``;
        or, with ``engine="philox"``, Philox-4x32-10 on global counters (K7),
        the counterpart of the JAX package's ``engine="pallas"`` (the TPU's
        hardware generator): the same invariants, fewer integer operations
        per word; reproducible from (key, seed, bit, batch index) like the
        counter engine, but its bits are its own (ops/encrypt_kernels.py).
        `bits` may be a tensor, an array or a list; it is moved to the key's
        device.
        """
        fn = _ENGINES[_engine_for(rng, engine)]
        bits = torch.as_tensor(bits, device=self.device)
        if bits.dim() != 1:
            raise ValueError(f"encrypt_batch expects bits[batch], got shape {tuple(bits.shape)}")
        batch = int(bits.shape[0])
        with op_metrics().record(
            "key.encrypt", chunks_out=batch, bytes_moved=self.ctx.chunk_count_bytes(batch),
        ):
            return fn(rng, bits, *self.encrypt_operands)

    # -- decryption ---------------------------------------------------------

    def _check(self, ciphertext: Ciphertext) -> None:
        if ciphertext.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")

    def decrypt(self, ciphertext: Ciphertext) -> Plaintext:
        """Decrypt any-length ciphertext: parity of per-chunk ANDs, over the
        physical payload (the parity ignores chunk order, and pad chunks
        never match)."""
        self._check(ciphertext)
        with op_metrics().record(
            "key.decrypt", chunks_in=ciphertext.chunks,
            bytes_moved=self.ctx.chunk_count_bytes(ciphertext.physical_chunks),
        ):
            return Plaintext(int(dispatch.decrypt_parity(ciphertext.wt, self._mask_t)))

    def decrypt_batch(self, words) -> torch.Tensor:
        """Decrypt a batch of ciphertexts -> bits int32[batch].

        Accepts either fresh single-chunk batches ``int32[W, batch]`` (parity
        of one chunk == its match bit) or a `CiphertextBatch` / grown payload
        ``int32[batch, W, chunks]`` (per-element parity across chunks; pad
        chunks never match, so lazy payloads decrypt directly).
        """
        w = self.ctx.words32
        if isinstance(words, CiphertextBatch):
            if words.ctx != self.ctx:
                raise ValueError("ciphertext context mismatch")
            words = words.wt
        if not isinstance(words, torch.Tensor):
            raise TypeError(f"decrypt_batch expects a torch.Tensor, got {type(words).__name__}")
        words = words.contiguous()  # the kernels read dense rows
        if words.dim() == 3:
            if words.shape[1] != w:
                raise ValueError(
                    f"decrypt_batch grown payload must be [batch, W={w}, chunks], "
                    f"got {tuple(words.shape)}"
                )
            with op_metrics().record(
                "key.decrypt_batch", chunks_in=words.shape[0] * words.shape[-1],
                bytes_moved=words.numel() * 4,
            ):
                return dispatch.decrypt_parity(words, self._mask_t).to(torch.int32)
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
        (csrc/mul.cu).  It takes ``*``'s route
        (`ops.dispatch.mul_decrypt_auto`; the parity is chunk-order
        independent), so the product carries the same order tag as ``c1 *
        c2`` (canonical under `set_eager_order(True)`).  Bit-exact to
        ``self.decrypt(c1 * c2)``.
        """
        self._check(c1)
        self._check(c2)
        t1, t2 = c1.chunks, c2.chunks
        with op_metrics().record(
            "key.mul_and_decrypt", chunks_in=t1 + t2, chunks_out=t1 * t2,
            bytes_moved=self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            if ct_mod._EAGER_ORDER:
                a, b = c1.canonical(), c2.canonical()
                out, parity = dispatch.mul_decrypt(a.wt, b.wt, self._mask_t)
                return Ciphertext(out, self.ctx), Plaintext(int(parity))
            out, jmajor, zp_a, zp_b, parity = dispatch.mul_decrypt_auto(c1.wt, c2.wt,
                                                                        self._mask_t)
            tag = product_tag(c1, c2, out, jmajor, zp_a, zp_b)
            return Ciphertext(out, self.ctx, *tag), Plaintext(int(parity))

    def mul_and_decrypt_batch(self, cb1: CiphertextBatch, cb2: CiphertextBatch):
        """Batched fused multiply + decrypt: ``(cb1 * cb2, bits int32[B])`` —
        every element's product and its decrypt parity in one launch, on
        `ops.dispatch.mul_decrypt_batched_auto`'s route (one shared tag).
        Bit-exact to ``self.decrypt_batch(cb1 * cb2)``."""
        if not isinstance(cb1, CiphertextBatch) or not isinstance(cb2, CiphertextBatch):
            raise TypeError("mul_and_decrypt_batch expects CiphertextBatch operands")
        if cb1.ctx != self.ctx or cb2.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")
        if cb1.batch != cb2.batch:
            raise ValueError(f"batch mismatch: {cb1.batch} vs {cb2.batch}")
        t1, t2 = cb1.chunks, cb2.chunks
        with op_metrics().record(
            "key.mul_and_decrypt_batch", chunks_in=cb1.batch * (t1 + t2),
            chunks_out=cb1.batch * t1 * t2,
            bytes_moved=cb1.batch * self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            out, jmajor, zp_a, zp_b, bits = dispatch.mul_decrypt_batched_auto(
                cb1.wt, cb2.wt, self._mask_t)
            tag = product_tag(cb1, cb2, out, jmajor, zp_a, zp_b)
            return CiphertextBatch(out, self.ctx, *tag), bits.to(torch.int32)

    def decrypt_product(self, cts: list[Ciphertext]) -> Plaintext:
        """Decrypt a product WITHOUT materializing it: Dec(∏ cᵢ) = ∧ Dec(cᵢ)."""
        acc = 1
        for ct in cts:
            acc &= int(self.decrypt(ct))
            if acc == 0:
                break
        return Plaintext(acc)

    # -- circuits (csgn_tpu_torch.circuit) -----------------------------------

    def _leaf_bits(self, ct):
        """Decrypt one expr leaf: int for a Ciphertext, uint8[B] for a
        `CiphertextBatch` (one batched launch)."""
        if isinstance(ct, CiphertextBatch):
            return self.decrypt_batch(ct).cpu().numpy().astype(np.uint8)
        return int(self.decrypt(ct))

    def decrypt_batches_packed(self, cbs) -> list[int]:
        """Decrypt many `CiphertextBatch`es -> `pack_fleet_bits`-packed ints
        (instance i at bit i), in input order.

        Same-shape batches concatenate into ONE `decrypt_batch` launch — the
        shared leaf-decrypt engine for fleet circuit readouts
        (`decrypt_circuits`, the executor's key-side netlist route)."""
        for cb in cbs:
            if cb.ctx != self.ctx:
                raise ValueError("ciphertext context mismatch")
        groups: dict[tuple, list[int]] = {}
        for i, cb in enumerate(cbs):
            groups.setdefault(tuple(cb.wt.shape), []).append(i)
        packed = [0] * len(cbs)
        for idxs in groups.values():
            stacked = CiphertextBatch(torch.cat([cbs[i].wt for i in idxs]), self.ctx)
            vals = self.decrypt_batch(stacked).cpu().numpy()
            b = cbs[idxs[0]].batch
            for gi, i in enumerate(idxs):
                packed[i] = pack_fleet_bits(vals[gi * b : (gi + 1) * b])
        return packed

    def decrypt_circuit(self, expr) -> "Plaintext | np.ndarray":
        """Decrypt a +/* DAG of ciphertexts WITHOUT materializing it.

        Dec is a ring homomorphism (reference src/SecretKey.cpp:126-146):
        Dec(a+b) = Dec(a)^Dec(b), Dec(a*b) = Dec(a)&Dec(b).  Cost is
        O(sum of distinct leaf chunks) — each leaf decrypts once (memoized),
        bits fold through the DAG on the host.  Accepts a `circuit.CtExpr` or
        a plain Ciphertext.  DAGs over `CiphertextBatch` leaves fold the whole
        B-fleet at once and return uint8[B] instead of a Plaintext.
        """
        e = lift(expr)
        bit = e.fold(self._leaf_bits)
        if e.batch is not None:
            return unpack_fleet_bits(bit, e.batch)
        return Plaintext(bit)

    def decrypt_circuits(self, exprs) -> "list[Plaintext | np.ndarray]":
        """Decrypt MANY +/* DAGs sharing leaves with batched leaf decrypts.

        Collects the distinct leaves across ALL the DAGs, decrypts each
        same-shape group in ONE batched launch (`decrypt_batch`), and folds
        every DAG on the host from the shared bit table, with one memo
        across the DAGs (`circuit.fold_many`).  Bit-exact to per-expr
        `decrypt_circuit`.  Fleet DAGs come back as uint8[B] arrays.
        """
        exprs = [lift(e) for e in exprs]
        leaves = collect_leaves(exprs)
        for ct in leaves:
            if ct.ctx != self.ctx:
                raise ValueError("ciphertext context mismatch")
        scalars = [ct for ct in leaves if isinstance(ct, Ciphertext)]
        fleets = [ct for ct in leaves if isinstance(ct, CiphertextBatch)]
        bits: dict[int, int] = {}
        groups: dict[tuple, list[Ciphertext]] = {}
        for ct in scalars:
            groups.setdefault(tuple(ct.wt.shape), []).append(ct)
        for cts in groups.values():
            batch = CiphertextBatch(torch.stack([c.wt for c in cts]), self.ctx)
            for c, v in zip(cts, self.decrypt_batch(batch).tolist()):
                bits[id(c)] = int(v)
        for cb, packed in zip(fleets, self.decrypt_batches_packed(fleets)):
            bits[id(cb)] = packed
        vals = fold_many(exprs, lambda ct: bits[id(ct)])
        return [
            unpack_fleet_bits(v, e.batch) if e.batch is not None else Plaintext(v)
            for e, v in zip(exprs, vals)
        ]

    def recrypt(self, ciphertext: Ciphertext, rng) -> Ciphertext:
        """Key-side re-encryption: decrypt, then a fresh 1-chunk ciphertext
        of the same bit (the growth reset of this bounded scheme); `rng` as
        `encrypt_batch`."""
        return self.encrypt(int(self.decrypt(ciphertext)), rng)

    # -- permutation --------------------------------------------------------

    def permute_and_decrypt(
        self, ciphertext: Ciphertext, p: Permutation
    ) -> tuple[Ciphertext, Plaintext]:
        """Key rotation + readout: ``(π(c), Dec_{π(k)}(π(c)))``.

        The reference's permute-then-decrypt flow (tests/timings.cpp:56-66),
        staged (K8 then K3) as the JAX package keeps it (see
        `ops.dispatch.permute_decrypt`).  By the transform identity the
        result equals ``self.decrypt(ciphertext)``.  The order tag and pad
        chunks carry over.
        """
        self._check(ciphertext)
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        psk = self.apply_permutation(p)
        with op_metrics().record(
            "key.permute_and_decrypt", chunks_in=ciphertext.chunks,
            chunks_out=ciphertext.chunks,
            bytes_moved=2 * self.ctx.chunk_count_bytes(ciphertext.physical_chunks),
        ):
            out, parity = dispatch.permute_decrypt(ciphertext.wt, p.benes_plan(), psk.mask_words)
            return (Ciphertext(out, self.ctx, ciphertext.logical, ciphertext.pad),
                    Plaintext(int(parity)))

    def apply_permutation(self, p: Permutation) -> "SecretKey":
        """Key transform: Dec_{π(k)}(π(c)) = Dec_k(c), a new key on the same
        device.

        The permuted key's positions are { i : π[i] ∈ s } = π⁻¹[s]; the
        reference re-extracts them in ascending order
        (src/SecretKey.cpp:244-250), which we match.
        """
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        inv = np.argsort(p.perm)
        return SecretKey(self.ctx, np.sort(inv[self.indices]).astype(np.int32), self.device)

    def __repr__(self) -> str:
        return f"SecretKey(ctx={self.ctx}, d={self.ctx.d}, device={self.device})"

    def __str__(self) -> str:
        # Space-separated index list, as the reference prints it
        # (src/SecretKey.cpp:22-29).
        return " ".join(str(int(x)) for x in self.indices) + " "
