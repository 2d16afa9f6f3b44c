"""The vertex attention's dispatch and plain path on the CPU, and the
arithmetic of its CUDA kernel (csrc/vertex_attention.cu) in float32 PyTorch.

The kernel itself runs only on the card (tests/test_torch_port_cuda.py). Here:
CPU tensors take the eager version and leave the kernel's launch count alone;
the eager version's gradient, which training keeps wherever an input needs
one, against finite differences; the kernel wrapper refuses what the kernel
does not take before it loads anything; and the kernel's algebra on small
shapes: the max taken from the least squared distance is the eager path's
max bit for bit, the pass test never drops a pair whose logit is above 0,
and the modified softmax summed per pair as (e - e0) w with V e0 added to the
normaliser is the eager result.
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch.ops import vertex_attention as va

SLACK = 1e-5   # csrc/vertex_attention.cu's kSlack
# float32 sums in another order (per pair here, per chunk in the eager
# version, which also subtracts e0 sum_v w_v after summing): a few ulps of the
# largest warp vector, far below what a wrong term moves (the correction term
# alone is 1e-3 and more of the largest warp where M < 104)
ALGEBRA_REL = 1e-5


def _inputs(rs, R, S, V, shift=0.0, meshes=3):
    """Rays from a circle of radius 2.4 at a body-sized box of vertices, each
    ray's mesh gathered from `meshes` poses as the pipeline gathers its table;
    `shift` moves the vertices away along x."""
    table = rs.uniform(-1, 1, (meshes, V, 3)) * np.array([0.4, 0.9, 0.25]) + [shift, 0, 0]
    warp_table = rs.normal(0, 0.05, (meshes, V, 3))
    pick = rs.randint(0, meshes, R)
    angle = rs.uniform(0, 2 * np.pi, R)
    origins = np.stack([2.4 * np.cos(angle), rs.normal(0, 0.1, R), 2.4 * np.sin(angle)], -1)
    target = table[pick, rs.randint(0, V, R)] - [shift, 0, 0] + rs.normal(0, 0.05, (R, 3))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.linspace(1.0, 4.0, S)[None, :] + rs.uniform(0, 3.0 / S, (R, S))
    samples = origins[:, None, :] + z[..., None] * dirs[:, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (samples, table[pick], warp_table[pick]))


@pytest.mark.parametrize("grad", [True, False])
def test_cpu_tensors_take_the_plain_path(grad):
    s, g, w = _inputs(np.random.RandomState(0), 4, 8, 50)
    before = (va.calls, va.pairs, va.launches)
    with torch.set_grad_enabled(grad):
        got = va.vertex_attention_warp(s, g, w, 0.15, 1e4)
    assert (va.calls, va.pairs, va.launches) == (before[0] + 1, before[1] + 4 * 8 * 50,
                                                  before[2])
    assert torch.equal(got, va.vertex_attention_eager(s, g, w, 0.15, 1e4))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_the_plain_paths_gradient_matches_finite_differences(which):
    # float64, a radius and temperature at which every sample sees several
    # vertices, chunks of 4 over 7 vertices (a ragged last chunk)
    inputs = [t.double() for t in _inputs(np.random.RandomState(1), 2, 3, 7)]
    inputs[which].requires_grad_(True)

    def fn(x):
        args = list(inputs)
        args[which] = x
        return va.vertex_attention_warp(*args, 0.9, 3.0, chunk_size=4)

    assert torch.autograd.gradcheck(fn, (inputs[which],), eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("dtype,error", [(torch.float64, TypeError), (torch.bfloat16, TypeError),
                                         (torch.float32, ValueError)])
def test_the_kernel_wrapper_refuses_before_loading(dtype, error):
    s, g, w = (t.to(dtype) for t in _inputs(np.random.RandomState(2), 2, 4, 9))
    with pytest.raises(error):
        va.vertex_attention_cuda(s, g, w, 0.15, 1e4)


def _kernel_arithmetic(samples, goal, warps, radius, temperature):
    """The kernel's arithmetic on the whole [R, S, V] at once: (warp, pairs
    its pass test takes, pairs whose logit is above 0, its M, eager's max)."""
    r, T = np.float32(radius), np.float32(temperature)
    d = samples[:, :, None, :] - goal[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    att = torch.relu(r - torch.sqrt(torch.clamp(d2, min=1e-24))) * T
    # launch 1: the least d2 of the batch, then its logit
    m = torch.clamp(torch.relu(r - torch.sqrt(torch.clamp(d2.min(), min=1e-24))) * T, min=0)
    e0 = torch.exp(-m)
    # launch 2: t = |v|^2 (1 - k) - 2 s.v against r^2 (1 + k) - |s|^2 (1 - k)
    q = (goal * goal).sum(-1) * np.float32(1 - SLACK)
    t = q[:, None, :] + (samples[:, :, None, :] * (-2 * goal[:, None, :, :])).sum(-1)
    r2 = np.float32(float(r) ** 2 * (1 + SLACK)) if r > 0 else -np.inf
    thr = r2 - (samples * samples).sum(-1) * np.float32(1 - SLACK)
    hit = t < thr[..., None]
    de = torch.where(hit, torch.exp(att - m) - e0, torch.zeros(()))
    den = de.sum(-1) + goal.shape[1] * e0
    warp = torch.einsum("rsv,rvc->rsc", de, warps) / torch.clamp(den, min=1e-30)[..., None]
    eager_att = torch.relu(r - va._dist(samples, goal)) * T
    return warp, hit, att > 0, m, torch.clamp(eager_att.max(), min=0)


@pytest.mark.parametrize("radius,temperature,shift", [
    (0.15, 1e4, 0.0),     # the cell's radius and temperature: M ~ 1,400
    (0.3, 100.0, 0.0),    # soft: many vertices share a sample's weight
    (0.15, 60.0, 0.0),    # M < 104: e0 is not 0 and the correction term counts
    (0.15, 1e4, 10.0),    # every sample outside every sphere: M = 0, the warp 0
])
def test_the_kernels_arithmetic_is_the_eager_result(radius, temperature, shift):
    s, g, w = _inputs(np.random.RandomState(3), 6, 16, 300, shift=shift)
    got, hit, inside, m, eager_m = _kernel_arithmetic(s, g, w, radius, temperature)
    want = va.vertex_attention_eager(s, g, w, radius, temperature, chunk_size=128)
    assert torch.equal(m, eager_m)
    assert bool(hit[inside].all())
    assert int(hit.sum()) <= int(inside.sum()) + 0.01 * hit.numel()
    assert float((got - want).abs().max()) <= ALGEBRA_REL * float(w.abs().max())
    if shift:
        assert float(m) == 0.0 and not bool(inside.any()) and not bool(got.any())
    if temperature < 100:
        assert float(m) < 104
        correction = float(torch.exp(-m)) * w.sum(1).abs().max()
        assert correction > 1e-3 * float(want.abs().max())
