"""Tools of the port, each run as ``python -m csgn_tpu_torch.tools.<name>``
(on the current CUDA device unless given ``--device cpu``):

  * `enc_stats` — the Philox engine's statistics;
  * `validate` — every kernel's shape classes against its plain version
    (the JAX package's tools/tpu_validate.py);
  * `serve_demo` — `BatchExecutor` against per-request calls;
  * `multihost_demo` — the sharded multiply and decrypt over a job of ranks;
  * `fault_demo` — a rank killed mid-step, the chain resumed from its
    checkpoint;
  * `scaling_bench` — the sharded fused multiply+decrypt rate per world size;
  * `ab_times` — kernel times for comparing two trees on one card.
"""
