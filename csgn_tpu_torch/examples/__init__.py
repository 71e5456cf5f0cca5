"""Example programs of the port, one module each, run as
``python -m csgn_tpu_torch.examples.<name> [--device cpu]``:

  * `voting` — an encrypted ballot: parity by the ``+`` fold, unanimity by
    `pipeline.mul_chain`;
  * `deep_chain` — a multiplication chain kept bounded by key-side
    `SecretKey.recrypt`;
  * `key_rotation` — a fleet re-keyed under one permutation per element
    (`CiphertextBatch.apply_permutations`);
  * `bristol_adder` — 64-bit addition from the Bristol-format
    ``tests/circuits/adder64.txt``, decrypted key-side;
  * `netlist_service` — a sealed-bid comparison service: one batched encrypt
    flush of `BatchExecutor`, `comparator_gt` netlists;
  * `encrypted_aes` — AES-128 under encryption (FIPS-197 C.1);
  * `encrypted_hmac` — HMAC-SHA-256 with an encrypted key (against hmac);
  * `sharded_pipeline` — encrypt, square and decrypt over a mesh of ranks
    (`csgn_tpu_torch.parallel`).

Each is the JAX package's ``examples/<name>.py`` on the port: the same
``main(...)`` arguments and returned dict, plus a ``device`` argument (None:
the current CUDA device; ``"cpu"``: the plain torch versions).  Every key is
the JAX example's: ``rng.split(rng.key(seed), k)`` is
``jax.random.split(jax.random.key(seed), k)``, and the draws made from the
keys (`rng.bernoulli` for the votes, `rng.randint` for the bids' seed) are
`jax.random`'s, so the secret keys, ciphertext words and returned values
equal the JAX example's; every decrypted result is asserted against its
plaintext expectation.
"""
