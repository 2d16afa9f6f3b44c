"""Isotropic Gaussian mixture over SMPL vertices, and the modified softmax
(counterpart of smpl_nerf_tpu/core/gmm.py).

`GaussianMixture.pdf` is the density prior of the optional GMM loss
(`--use_gmm_loss`): an equal-weight mixture with one isotropic Gaussian per
canonical vertex. Squared distances use the ||x||^2 - 2<x, mu> + ||mu||^2
expansion, as the JAX package does, so the inner term is one matmul.
`modified_softmax` maps a zero activation to exactly zero weight; the
vertex-attention warp (ops/vertex_attention.py) computes it chunk by chunk.
"""
from __future__ import annotations

import numpy as np
import torch

PDF_CHUNK = 16384     # sample rows per [rows, V] distance block


def modified_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax with f(0) = 0: (exp(x - max) - exp(-max)) / sum(exp(x - max)),
    the max taken over the WHOLE tensor."""
    x_max = torch.max(x)
    e = torch.exp(x - x_max)
    return (e - torch.exp(-x_max)) / torch.sum(e, -1, keepdim=True)


class GaussianMixture:
    """Equal-weight isotropic GMM with means at the canonical SMPL vertices."""

    def __init__(self, means, std: float):
        # [V, D]; a tensor keeps its device
        self.means = torch.as_tensor(means, dtype=torch.float32)
        self.var = float(std) ** 2
        dim = self.means.shape[-1]
        self.factor = 1.0 / np.sqrt((2 * np.pi) ** dim * self.var ** dim)

    @torch.no_grad()
    def pdf(self, samples: torch.Tensor) -> torch.Tensor:
        """samples [..., D] -> mixture density [...], without a gradient (the
        loss's samples carry none: coarse samples come from the jitter, fine
        ones from detached inverse-CDF draws). Rows go PDF_CHUNK at a time, so
        the [rows, V] block stays bounded."""
        if samples.shape[-1] != self.means.shape[-1]:
            raise ValueError(f"sample dim {samples.shape[-1]} != gaussian dim "
                             f"{self.means.shape[-1]}")
        means = self.means.to(samples.device)
        mu2 = torch.sum(means ** 2, -1)                                  # [V]
        flat = samples.reshape(-1, samples.shape[-1]).float()
        out = torch.empty(flat.shape[0], device=samples.device)
        for lo in range(0, flat.shape[0], PDF_CHUNK):
            x = flat[lo:lo + PDF_CHUNK]
            sq = torch.sum(x ** 2, -1, keepdim=True) - 2.0 * (x @ means.T) + mu2[None, :]
            probs = self.factor * torch.exp(-0.5 * sq / self.var)
            out[lo:lo + PDF_CHUNK] = torch.sum(probs, -1) / means.shape[0]
        return out.reshape(samples.shape[:-1])
