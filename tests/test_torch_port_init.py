"""The port's lecun-normal init against flax's `nn.initializers.lecun_normal()`.

Flax draws a standard normal truncated to [-2, 2] and scales it to std
sqrt(1 / fan_in) (`variance_scaling(1, "fan_in", "truncated_normal")`, whose
1 / 0.8796 undoes the truncation's std). A draw clipped at +-2 and scaled the
same way has std ~1.09 x sqrt(1 / fan_in) and piles ~4.6 % of its entries
on +-2 truncation std; its CDF stands Phi(-2) = 0.023 off the truncated one
just inside -2.

Checks, on a 256 x 256 `init_linear_` kernel (65,536 entries) and on the
estimator's 3 x 3 convolution kernel [128, 64, 3, 3] (73,728), each from a
seed: the std within 1 % of sqrt(1 / fan_in) (the std of a sample this size
wobbles by ~0.3 %), no entry at or past the truncation (2 / 0.8796 std), and
the two-sample Kolmogorov-Smirnov statistic against flax's draw at the same
shape below 0.015 (at these sizes two draws of one distribution stay below
~0.011 with probability 0.999). The old clipped draw fails that statistic.
"""
import _torch_threads  # noqa: F401

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from smpl_nerf_tpu_torch.models import smpl_estimator
from smpl_nerf_tpu_torch.models.render_ray_net import init_linear_

STD_REL, KS_MAX = 1e-2, 0.015
TRUNC = 0.87962566103423978          # the std of a standard normal truncated to [-2, 2]


def _ks(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic: the largest gap of the two
    empirical CDFs."""
    a, b = np.sort(a.ravel()), np.sort(b.ravel())
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(fa - fb).max())


def _clipped(shape, fan_in: int, seed: int) -> np.ndarray:
    """The draw the port made before: a normal clipped at +-2, same scale."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.empty(shape).normal_(0.0, 1.0, generator=gen).clamp_(-2.0, 2.0)
    return (w * math.sqrt(1.0 / fan_in) / TRUNC).numpy()


def _linear_kernel(seed: int) -> tuple:
    layer = torch.nn.Linear(256, 256)
    init_linear_(layer, torch.Generator().manual_seed(seed))
    assert not layer.bias.any()
    return layer.weight.detach().numpy(), 256


def _conv_kernel(seed: int) -> tuple:
    est = smpl_estimator.SmplEstimator(image_size=(32, 32),
                                       generator=torch.Generator().manual_seed(seed))
    conv = est.conv3                                   # 64 -> 128 channels: [128, 64, 3, 3]
    assert not conv.bias.any()
    return conv.weight.detach().numpy(), 64 * 9


def _flax(shape, fan_in: int, seed: int) -> np.ndarray:
    """flax's lecun_normal at the same fan-in: flax reads fan-in off axis -2
    of a Dense kernel [in, out] and off the product of the other axes for a
    conv's [kh, kw, in, out]."""
    flax_shape = ((fan_in, shape[0]) if len(shape) == 2
                  else (shape[2], shape[3], shape[1], shape[0]))
    w = nn.initializers.lecun_normal()(jax.random.PRNGKey(seed), flax_shape, jnp.float32)
    return np.asarray(w)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_init_is_flax_lecun_normal(kind):
    w, fan_in = (_linear_kernel if kind == "linear" else _conv_kernel)(seed=3)
    want = _flax(w.shape, fan_in, seed=4)
    std = math.sqrt(1.0 / fan_in)
    assert abs(float(w.std()) / std - 1.0) <= STD_REL
    assert abs(float(want.std()) / std - 1.0) <= STD_REL
    assert float(np.abs(w).max()) < 2.0 * std / TRUNC            # nothing at the truncation
    assert _ks(w, want) < KS_MAX


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_the_old_clipped_draw_fails_the_same_check(kind):
    w, fan_in = (_linear_kernel if kind == "linear" else _conv_kernel)(seed=3)
    old = _clipped(w.shape, fan_in, seed=5)
    want = _flax(w.shape, fan_in, seed=4)
    assert _ks(old, want) >= KS_MAX
    assert float(old.std()) / math.sqrt(1.0 / fan_in) > 1.05
    at_edge = np.isclose(np.abs(old), 2.0 * math.sqrt(1.0 / fan_in) / TRUNC).mean()
    assert 0.03 < at_edge < 0.06


def test_every_seeded_net_draws_the_same_weights_twice():
    """The draw is the seeded CPU generator's alone."""
    a, _ = _linear_kernel(seed=7)
    b, _ = _linear_kernel(seed=7)
    c, _ = _linear_kernel(seed=8)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
