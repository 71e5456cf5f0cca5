"""Run configuration for the CLI, as JSON.

The JAX package's `csgn_tpu.config.RunConfig`, field for field, so a JSON
file written by either package loads in the other.  The reference hard-codes
Context(1247, 16) in every test (reference tests/basic_operations.cpp:14);
here a frozen dataclass carries the scheme parameters, the seed and the
batch size.  ``mesh_devices`` and ``mul_strategy`` configure the JAX
package's multi-device layer; the port carries them and does not use them
until its own multi-device layer (`parallel/`) exists.
"""

from __future__ import annotations

import dataclasses
import json

from csgn_tpu_torch.context import Context

__all__ = ["RunConfig"]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Scheme + execution parameters for CLI runs."""

    n: int = 1247
    d: int = 16
    seed: int = 0
    batch: int = 1024          # batched-encryption workload size
    mesh_devices: int = 0      # carried, unused: 0 = all visible devices
    mul_strategy: str = "allgather"  # carried, unused: or "ring"

    def context(self) -> Context:
        return Context(self.n, self.d)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)
