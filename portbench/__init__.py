"""The benchmark of `csgn_tpu_torch` on one NVIDIA H100: cells of a deployment
under a traffic mix, found by name from ``BENCHMARK.json`` at the checkout's
root (`portbench.harness`).  ``python3 -m portbench.run`` runs one cell once."""
