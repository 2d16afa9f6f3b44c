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

The same for kernel H (csrc/relu_attention.cu), image_wise_dynamic's
normalised-ReLU attention: CPU tensors take `relu_attention_eager` and leave
`relu_launches` alone; `relu_attention_backward_plain`, H's closed-form
backward, is autograd's through the eager path, with a sample on a vertex, one
on a sphere's edge and one outside every sphere; both forms of H's pass test
(samples held, vertices held) take every pair with a > 0; H's wrapper refuses
what H does not take before it loads anything.
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch.ops import _build
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


# ------------------------------------- kernel H: the normalised-ReLU attention

def _relu_inputs(rs, R, S, V, shift=0.0):
    """`_inputs` with one mesh for every ray, as image_wise_dynamic attends:
    samples [R, S, 3], goal vertices and warp vectors [V, 3]."""
    s, g, w = _inputs(rs, R, S, V, shift=shift, meshes=1)
    return s, g[0].contiguous(), w[0].contiguous()


def _special_samples(s, g, radius):
    """Three samples of the first ray made special: exactly on vertex 0 (the
    1e-24 clamp), exactly on the edge of vertex 1's sphere (a = 0 there: the
    offset and the radius are exact in binary) and far outside every sphere."""
    s, g = s.clone(), g.clone()
    g[0] = torch.tensor([0.25, -0.5, 0.125])
    g[1] = torch.tensor([-0.25, 0.5, -0.125])
    s[0, 0] = g[0]
    s[0, 1] = g[1] + torch.tensor([radius, 0.0, 0.0])
    s[0, 2] = torch.tensor([9.0, 9.0, 9.0])
    return s, g


@pytest.mark.parametrize("grad", [True, False])
def test_relu_cpu_tensors_take_the_plain_path(grad):
    s, g, w = _relu_inputs(np.random.RandomState(4), 4, 8, 50)
    before = (va.relu_calls, va.relu_pairs, va.relu_launches)
    with torch.set_grad_enabled(grad):
        got = va.relu_attention_warp(s, g.requires_grad_(grad), w, 0.15)
    assert (va.relu_calls, va.relu_pairs, va.relu_launches) == (
        before[0] + 1, before[1] + 4 * 8 * 50, before[2])
    assert got.requires_grad == grad
    assert torch.equal(got, va.relu_attention_eager(s, g, w, 0.15))


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_relu_plain_backward_is_autograds_through_the_eager_path(dtype, rel):
    # a radius at which most samples see several vertices; chunks of 64 over
    # 150 vertices (a ragged last chunk)
    radius = 0.5
    s, g, w = _relu_inputs(np.random.RandomState(5), 3, 16, 150)
    s, g = _special_samples(s, g, radius)
    s, g, w = (t.to(dtype) for t in (s, g, w))
    d = s[0, :2] - g[:2]
    assert float((d[0] * d[0]).sum()) == 0.0 and float((d[1] * d[1]).sum()) == radius ** 2
    leaves = [t.clone().requires_grad_(True) for t in (s, g, w)]
    out = va.relu_attention_eager(*leaves, radius, chunk_size=64)
    cot = torch.from_numpy(np.random.RandomState(6).normal(size=out.shape)).to(dtype)
    want = torch.autograd.grad(out, leaves, cot)
    got = va.relu_attention_backward_plain(s, g, w, radius, cot, chunk_size=64)
    assert not bool(out[0, 2].any())                       # outside every sphere: no warp
    for name, a, b in zip(("samples", "goal", "warps"), got, want):
        assert float(b.abs().max()) > 0.0, name
        assert float((a - b).abs().max()) <= rel * float(b.abs().max()), name
    # the sample on vertex 0 takes no gradient through that pair's distance,
    # the one outside every sphere none at all
    assert not bool(got[0][0, 2].any())


def _fma(a, b, c):
    """float32 fmaf through float64 (the product of two float32 is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _test_point(p):
    """csrc/relu_attention.cu's test_point: (-2x, -2y, -2z), |x|^2 (1 - k), with
    its k = kSlack = SLACK, G's."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    q = _fma(x, x, _fma(y, y, z * z)) * np.float32(1 - np.float32(SLACK))
    return -2 * p, q


def _test_threshold(p, r2_slack):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    q = _fma(x, x, _fma(y, y, z * z))
    return np.float32(r2_slack) - q * np.float32(1 - np.float32(SLACK))


def _passes(held, streamed, r2_slack):
    """[P, Q] pass test of points `held` (registers) against `streamed` (shared)."""
    thr = _test_threshold(held, r2_slack)[:, None]
    m2, q = _test_point(streamed)
    x, y, z = (held[:, None, i] for i in range(3))
    return _fma(x, m2[None, :, 0], _fma(y, m2[None, :, 1], _fma(z, m2[None, :, 2], q[None]))) < thr


@pytest.mark.parametrize("radius,shift", [(0.15, 0.0), (0.15, 3.0), (0.5, 0.0), (0.02, 0.0)])
def test_relu_pass_test_never_drops_a_pair_inside(radius, shift):
    """Both of H's forms of the test (samples held, vertices streamed: the
    forward and the samples' gradient; vertices held: the vertices' gradient)
    take every pair with a > 0, with half of the samples put within 1e-7 of
    a sphere's edge (before rounding to float32), on either side, and the mesh `shift` away from the origin."""
    rs = np.random.RandomState(7)
    s, g, _ = _relu_inputs(rs, 6, 16, 300, shift=shift)
    s = s.reshape(-1, 3).numpy().copy()
    g = g.numpy()
    edge = rs.rand(len(s)) < 1 / 2
    u = rs.normal(size=(len(s), 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    scale = radius * (1 + rs.choice([-1e-7, -3e-8, 0.0, 3e-8, 1e-7], len(s)))
    near = g[rs.randint(0, len(g), len(s))] + u * scale[:, None]
    s[edge] = near[edge].astype(np.float32)
    r = np.float32(radius)
    r2_slack = np.float32(float(r) ** 2 * (1 + float(np.float32(SLACK))))
    inside = (torch.relu(torch.tensor(r) - va._dist(torch.from_numpy(s)[None],
                                                    torch.from_numpy(g)[None]))[0] > 0).numpy()
    dist = np.linalg.norm(s[:, None].astype(np.float64) - g[None], axis=-1)
    assert (inside & (np.abs(dist - radius) < 1e-6 * radius)).sum() >= 10   # pairs on an edge
    for hit in (_passes(s, g, r2_slack), _passes(g, s, r2_slack).T):
        assert hit[inside].all()
        assert hit.sum() <= inside.sum() + 0.01 * hit.size


def _no_library_loaded():
    return "relu_attention" not in _build._LIBS


@pytest.mark.parametrize("case,error,match", [
    ("float64", TypeError, "float32"),
    ("bfloat16", TypeError, "float32"),
    ("mixed devices", ValueError, "one CUDA device"),
    ("cpu", ValueError, "one CUDA device"),
    ("samples [R, 3]", ValueError, "takes samples"),
    ("goal [1, V, 3]", ValueError, "takes samples"),
    ("warps [V - 1, 3]", ValueError, "takes samples"),
    ("radius with a gradient", ValueError, "radius"),
    ("radius not finite", ValueError, "finite radius"),
])
def test_relu_kernel_wrapper_refuses_before_loading(case, error, match):
    s, g, w = _relu_inputs(np.random.RandomState(8), 2, 4, 9)
    radius = 0.15
    if case in ("float64", "bfloat16"):
        s, g, w = (t.to(getattr(torch, case)) for t in (s, g, w))
    elif case == "mixed devices":
        g = g.to("meta")
    elif case == "samples [R, 3]":
        s = s[:, 0]
    elif case == "goal [1, V, 3]":
        g = g[None]
    elif case == "warps [V - 1, 3]":
        w = w[1:]
    elif case == "radius with a gradient":
        radius = torch.tensor(0.15, requires_grad=True)
    elif case == "radius not finite":
        radius = float("nan")
    with pytest.raises(error, match=match):
        va.relu_attention_cuda(s, g, w, radius)
    assert _no_library_loaded()
