"""Running mean/std normalization.

Counterpart of `RunningMeanStd` in `pulse_tpu/learning/running_norm.py`:
batched updates by the parallel-variance (Chan et al.) merge of batch
moments, with the batch variance taken over N (ddof 0, as `jnp.var`), and
a clamp to ±5 on normalize. An update returns a new instance, so a caller
can keep the stats it started from; a frozen instance (`freeze`, as a
distillation teacher's input stats) returns itself.
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
    frozen: bool = False

    @classmethod
    def create(cls, dim: int, device=None) -> "RunningMeanStd":
        return cls(
            mean=torch.zeros(dim, device=device),
            var=torch.ones(dim, device=device),
            count=torch.tensor(1e-4, device=device),
        )

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        batch = batch.reshape(-1, batch.shape[-1])
        return self.update_moments(batch.mean(dim=0), batch.var(dim=0, correction=0), batch.shape[0])

    def update_moments(self, b_mean: torch.Tensor, b_var: torch.Tensor, b_count) -> "RunningMeanStd":
        """Chan-merge precomputed batch moments into the running ones."""
        if self.frozen:
            return self
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = self.var * self.count + b_var * b_count + delta**2 * self.count * b_count / tot
        return RunningMeanStd(mean=self.mean + delta * b_count / tot, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        return torch.clamp((x - self.mean) / torch.sqrt(self.var + 1e-5), -clip, clip)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self.var + 1e-5) + self.mean

    def freeze(self) -> "RunningMeanStd":
        return dataclasses.replace(self, frozen=True)


def running_mean_std_from_jax(d: dict, device=None) -> RunningMeanStd:
    """From a JAX RunningMeanStd's numpy leaves {mean, var, count}."""
    return RunningMeanStd(
        **{k: torch.tensor(np.asarray(d[k], np.float32), device=device) for k in ("mean", "var", "count")}
    )
