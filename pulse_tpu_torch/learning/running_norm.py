"""Running mean/std observation normalization.

Counterpart of `RunningMeanStd` in `pulse_tpu/learning/running_norm.py`
(normalize/denormalize; the batched update waits for the PPO update).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, dim: int, device=None) -> "RunningMeanStd":
        return cls(
            mean=torch.zeros(dim, device=device),
            var=torch.ones(dim, device=device),
            count=torch.tensor(1e-4, device=device),
        )

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        return torch.clamp((x - self.mean) / torch.sqrt(self.var + 1e-5), -clip, clip)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self.var + 1e-5) + self.mean


def running_mean_std_from_jax(d: dict, device=None) -> RunningMeanStd:
    """From a JAX RunningMeanStd's numpy leaves {mean, var, count}."""
    return RunningMeanStd(
        **{k: torch.as_tensor(np.asarray(d[k], np.float32), device=device) for k in ("mean", "var", "count")}
    )
