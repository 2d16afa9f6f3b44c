"""NeRF positional encoding (counterpart of smpl_nerf_tpu/core/encoding.py).

Frequency bands 2^0 .. 2^(L-1); concatenation order is
[identity?, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...] where each block
spans all D input dims. `output_dim` counts blocks per scalar (2L (+1)).
"""
from __future__ import annotations

import numpy as np
import torch


class PositionalEncoder:
    def __init__(self, number_frequencies: int, include_identity: bool):
        self.number_frequencies = int(number_frequencies)
        self.include_identity = bool(include_identity)
        self.output_dim = (1 if include_identity else 0) + 2 * self.number_frequencies
        if self.number_frequencies > 0:
            self.freq_bands = np.power(
                2.0, np.linspace(0.0, self.number_frequencies - 1, self.number_frequencies)
            ).astype(np.float32)
        else:
            self.freq_bands = np.zeros((0,), np.float32)

    def encode(self, coordinate: torch.Tensor) -> torch.Tensor:
        """coordinate [..., D] -> [..., D * output_dim] in reference block order."""
        parts = []
        if self.include_identity:
            parts.append(coordinate)
        if self.number_frequencies > 0:
            freqs = torch.as_tensor(self.freq_bands, device=coordinate.device)
            scaled = coordinate[..., None, :] * freqs[:, None]      # [..., F, D]
            interleaved = torch.stack([torch.sin(scaled), torch.cos(scaled)], -2)
            parts.append(interleaved.reshape(*coordinate.shape[:-1], -1))
        return torch.cat(parts, -1) if len(parts) > 1 else parts[0]

    def __call__(self, coordinate: torch.Tensor) -> torch.Tensor:
        return self.encode(coordinate)
