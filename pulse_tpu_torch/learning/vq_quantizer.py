"""Vector quantization for the VQ-VAE latent spaces.

Counterpart of `pulse_tpu/learning/vq_quantizer.py`: the nearest codebook
entry with straight-through gradients and the commit and codebook losses
(`quantize`), the codebook's exponential-moving-average update with
Laplace-smoothed counts (`ema_update`), and the sphere / uniform latent
projection (`project_to_norm`). The codebook state is passed in and out.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CodebookState:
    codebook: torch.Tensor      # [K, D]
    ema_counts: torch.Tensor    # [K]
    ema_means: torch.Tensor     # [K, D]


def create_codebook(num_codes: int, dim: int, generator: torch.Generator | None = None,
                    device=None) -> CodebookState:
    """A codebook of N(0, 0.1²) entries, its EMA counts one each and its EMA
    means the entries. The draw is made on the generator's device."""
    gen_device = generator.device if generator is not None else "cpu"
    cb = (0.1 * torch.randn(num_codes, dim, generator=generator, device=gen_device)).to(device)
    return CodebookState(codebook=cb, ema_counts=torch.ones(num_codes, device=cb.device), ema_means=cb.clone())


def codebook_from_jax(d: dict, device=None) -> CodebookState:
    """From a JAX CodebookState's numpy leaves {codebook, ema_counts,
    ema_means}."""
    return CodebookState(**{k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
                            for k in ("codebook", "ema_counts", "ema_means")})


def quantize(state: CodebookState, z: torch.Tensor):
    """z [..., D] -> (z_q with straight-through gradients, the indexes
    [...], {commit_loss, codebook_loss}). The nearest entry by squared
    distance |z|² - 2 z·c + |c|²."""
    cb = state.codebook
    flat = z.reshape(-1, z.shape[-1])
    d = (flat ** 2).sum(-1, keepdim=True) - 2.0 * flat @ cb.T + (cb ** 2).sum(-1)[None, :]
    idx = torch.argmin(d, dim=-1)
    z_q = cb[idx].reshape(z.shape)
    losses = {"commit_loss": torch.mean(torch.sum((z - z_q.detach()) ** 2, dim=-1)),
              "codebook_loss": torch.mean(torch.sum((z.detach() - z_q) ** 2, dim=-1))}
    return z + (z_q - z).detach(), idx.reshape(z.shape[:-1]), losses


def ema_update(state: CodebookState, z: torch.Tensor, idx: torch.Tensor, decay: float = 0.99) -> CodebookState:
    """The codebook's EMA update: each entry's count and sum of assigned z
    decayed in, the entry the mean over Laplace-smoothed counts."""
    K, D = state.codebook.shape
    flat, idx = z.reshape(-1, D), idx.reshape(-1)
    counts = torch.zeros(K, device=flat.device).index_add_(0, idx, torch.ones_like(idx, dtype=flat.dtype))
    means = torch.zeros(K, D, device=flat.device).index_add_(0, idx, flat)
    new_counts = decay * state.ema_counts + (1 - decay) * counts
    new_means = decay * state.ema_means + (1 - decay) * means
    n = new_counts.sum()
    stable = (new_counts + 1e-5) / (n + K * 1e-5) * n
    return CodebookState(codebook=new_means / stable[:, None], ema_counts=new_counts, ema_means=new_means)


def project_to_norm(x: torch.Tensor, norm: float = 5.0, z_type: str = "sphere") -> torch.Tensor:
    """"sphere": x scaled to norm `norm`; "uniform": x clipped to
    [-norm, norm]; else x."""
    if z_type == "sphere":
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) / norm + 1e-8)
    if z_type == "uniform":
        return torch.clamp(x, -norm, norm)
    return x
