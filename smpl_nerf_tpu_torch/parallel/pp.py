"""Pipeline parallelism: depth-split the RenderRayNet trunk over the mesh
(counterpart of smpl_nerf_tpu/parallel/pp.py).

At the reference's 8 layers x W=256 one device holds the whole trunk; this is
for the deep / wide regime whose weights or activations outgrow one.

  * The trunk is rewritten as L UNIFORM layers over a carried (h, x) pair,
        h' = relu(concat(h, x * use_x[l]) @ K[l] + b[l]),  K[l]: [W + D, W],
    with layer 0 (h = 0, use_x = 1) as positions_pose_input and the skip
    layers as use_x = 1 (`stack_trunk`); L is padded to a multiple of the
    stage count with exact identity layers (K = [I; 0], b = 0: relu(h) = h
    for a post-relu h). Stage s owns layers [s L/n, (s + 1) L/n).
  * `pipeline_trunk` runs the GPipe schedule over n_micro + n_stages - 1
    ticks: at tick t stage s applies its layers to microbatch t - s and sends
    (h, x) to stage s + 1 (point-to-point send / recv where JAX ppermutes);
    the last stage collects the outputs and broadcasts them over the group.
    Stage s only runs the ticks where it holds a microbatch (JAX's SPMD
    program computes the others and throws them away).
  * It is a torch.autograd.Function: the backward walks the microbatches in
    reverse, recomputes each stage's layers from the (h, x) it saved, and
    sends the cotangent of (h, x) back a stage. The stacked weights and the
    input are whole on every rank, as JAX's global arrays are, and so are
    their gradients (summed over the group), so the same function sits under
    a training step.
  * The heads (additional_linear_layer, sigma / rgb, the directional branch)
    run densely after the pipeline, on every rank (`pp_render_ray_net`).
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from smpl_nerf_tpu_torch.parallel.mesh import Mesh


def _layers(net: Union[torch.nn.Module, Mapping]) -> Mapping[str, torch.Tensor]:
    """{name: tensor} of a RenderRayNet or its state dict (torch names)."""
    if isinstance(net, torch.nn.Module):
        return dict(net.named_parameters())
    return net


def stack_trunk(net, n_layers: int, skips: Sequence[int], pos_dim: int, width: int,
                n_stages: int = 1):
    """RenderRayNet trunk -> (kernels [L, W+D, W], biases [L, W], use_x [L]).

    `net` is a RenderRayNet or its state dict; the stacks are built with torch
    ops, so gradients flow back to the net's parameters. L is padded up to a
    multiple of n_stages with exact identity layers."""
    p = _layers(net)
    D, W = pos_dim, width
    ref = p["positions_pose_input.weight"]
    zeros = lambda r, c: torch.zeros((r, c), dtype=torch.float32, device=ref.device)  # noqa: E731
    kernels, biases, use_x = [], [], []

    def uniform(name: str, with_x: bool, h_rows: bool):
        kernel = p[f"{name}.weight"].float().t()            # [in, out]
        if h_rows and with_x:           # skip layer: kernel is already [W+D, W]
            k = kernel
        elif h_rows:                    # plain hidden layer: [W, W]
            k = torch.cat([kernel, zeros(D, W)], 0)
        else:                           # layer 0: [D, W] lives on the x rows
            k = torch.cat([zeros(W, W), kernel], 0)
        kernels.append(k)
        biases.append(p[f"{name}.bias"].float())
        use_x.append(1.0 if with_x else 0.0)

    uniform("positions_pose_input", with_x=True, h_rows=False)
    for i in range(n_layers - 1):
        uniform(f"positional_net.{i}", with_x=i in tuple(skips), h_rows=True)
    while len(kernels) % n_stages:      # exact identity pad: relu(h @ I) == h
        kernels.append(torch.cat([torch.eye(W, dtype=torch.float32, device=ref.device),
                                  zeros(D, W)], 0))
        biases.append(torch.zeros(W, dtype=torch.float32, device=ref.device))
        use_x.append(0.0)
    return (torch.stack(kernels), torch.stack(biases),
            torch.tensor(use_x, dtype=torch.float32, device=ref.device))


def _apply_layers(kernels, biases, use_x, h, x):
    for l in range(kernels.shape[0]):
        h = torch.relu(torch.cat([h, x * use_x[l]], -1) @ kernels[l] + biases[l])
    return h


def trunk_dense(kernels, biases, use_x, x):
    """The unpipelined forward of a stacked trunk: what pipeline_trunk must equal."""
    h = torch.zeros(x.shape[:-1] + (kernels.shape[-1],), dtype=x.dtype, device=x.device)
    return _apply_layers(kernels, biases, use_x, h, x)


def _stage_group(mesh: Mesh, axis: str):
    """(group or None, global ranks of the stages in order, this stage, n_stages)."""
    group, index, n = mesh.axis(axis)
    return group, [0] if group is None else dist.get_process_group_ranks(group), index, n


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernels, biases, use_x, x_micro, mesh, axis):
        group, ranks, s, n = _stage_group(mesh, axis)
        lps = kernels.shape[0] // n
        k_l, b_l = kernels[s * lps:(s + 1) * lps], biases[s * lps:(s + 1) * lps]
        u_l = use_x[s * lps:(s + 1) * lps]
        n_micro, micro, D = x_micro.shape
        W = kernels.shape[-1]
        h_in, xs_in, sends = [], [], []
        out = torch.zeros((n_micro, micro, W), dtype=x_micro.dtype, device=x_micro.device)
        for m in range(n_micro):                     # stage s works at tick m + s
            if s == 0:
                h = torch.zeros((micro, W), dtype=x_micro.dtype, device=x_micro.device)
                xs = x_micro[m]
            else:
                h = torch.empty((micro, W), dtype=x_micro.dtype, device=x_micro.device)
                xs = torch.empty((micro, D), dtype=x_micro.dtype, device=x_micro.device)
                dist.recv(h, src=ranks[s - 1], group=group)
                dist.recv(xs, src=ranks[s - 1], group=group)
            h_in.append(h)
            xs_in.append(xs)
            h = _apply_layers(k_l, b_l, u_l, h, xs)
            if s < n - 1:
                sends += [dist.isend(h.contiguous(), dst=ranks[s + 1], group=group),
                          dist.isend(xs.contiguous(), dst=ranks[s + 1], group=group)]
            else:
                out[m] = h
        for work in sends:
            work.wait()
        if group is not None:        # only the last stage holds the outputs
            dist.broadcast(out, src=ranks[n - 1], group=group)
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(k_l, b_l, u_l, *h_in, *xs_in)
        ctx.shapes = (kernels.shape, biases.shape, x_micro.shape)
        return out

    @staticmethod
    def backward(ctx, g_out):
        group, ranks, s, n = _stage_group(ctx.mesh, ctx.axis)
        k_shape, b_shape, x_shape = ctx.shapes
        saved = ctx.saved_tensors
        k_l, b_l, u_l = saved[:3]
        n_micro = x_shape[0]
        h_in, xs_in = saved[3:3 + n_micro], saved[3 + n_micro:]
        lps = k_l.shape[0]
        dk = torch.zeros(k_shape, dtype=k_l.dtype, device=k_l.device)
        db = torch.zeros(b_shape, dtype=b_l.dtype, device=b_l.device)
        dx = torch.zeros(x_shape, dtype=g_out.dtype, device=g_out.device)
        sends = []
        for m in reversed(range(n_micro)):
            if s == n - 1:
                g_h = g_out[m]
                g_xs = torch.zeros_like(xs_in[m])
            else:
                g_h = torch.empty_like(h_in[m])
                g_xs = torch.empty_like(xs_in[m])
                dist.recv(g_h, src=ranks[s + 1], group=group)
                dist.recv(g_xs, src=ranks[s + 1], group=group)
            with torch.enable_grad():
                h = h_in[m].detach().requires_grad_(True)
                xs = xs_in[m].detach().requires_grad_(True)
                kk = k_l.detach().requires_grad_(True)
                bb = b_l.detach().requires_grad_(True)
                y = _apply_layers(kk, bb, u_l, h, xs)
                d_h, d_xs, d_k, d_b = torch.autograd.grad(y, (h, xs, kk, bb), g_h.contiguous(),
                                                          allow_unused=True)
            dk[s * lps:(s + 1) * lps] += d_k
            db[s * lps:(s + 1) * lps] += d_b
            d_xs = g_xs + (d_xs if d_xs is not None else 0.0)
            if s > 0:
                d_h = d_h if d_h is not None else torch.zeros_like(h_in[m])
                sends += [dist.isend(d_h.contiguous(), dst=ranks[s - 1], group=group),
                          dist.isend(d_xs.contiguous(), dst=ranks[s - 1], group=group)]
            else:
                dx[m] = d_xs
        for work in sends:
            work.wait()
        if group is not None:        # whole gradients on every rank, as JAX's are
            for t in (dk, db, dx):
                dist.all_reduce(t, group=group)
        return dk, db, None, dx, None, None


def pipeline_trunk(mesh: Mesh, kernels, biases, use_x, x, n_micro: int, axis: str = "model"):
    """Run the stacked trunk pipelined over mesh axis `axis` -> [N, W] on every rank.

    x: [N, D] encoded inputs, N divisible by n_micro; kernels / biases / use_x
    from stack_trunk (whole on every rank), L divisible by the stage count."""
    n_stages = int(mesh.shape[axis])
    L, WD, W = kernels.shape
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages "
                         "(stack_trunk(n_stages=...) pads)")
    N = x.shape[0]
    if N % n_micro:
        raise ValueError(f"N={N} not divisible by n_micro={n_micro}")
    x_micro = x.reshape(n_micro, N // n_micro, WD - W)
    return _Pipeline.apply(kernels, biases, use_x, x_micro, mesh, axis).reshape(N, W)


def pp_render_ray_net(mesh: Mesh, net, x, *, n_layers: int = 8, width: int = 256,
                      pos_dim: int = 60, dir_dim: int = 24, skips: Sequence[int] = (4,),
                      use_directional_input: bool = True, n_micro: int = 4,
                      axis: str = "model"):
    """The whole RenderRayNet forward (float32) with the trunk pipelined over
    the mesh: the same math as RenderRayNet.forward. `net` is a RenderRayNet
    or its state dict; x: [N, pos_dim (+ additional) + dir_dim]."""
    p = _layers(net)
    if pos_dim + dir_dim != x.shape[-1]:
        raise ValueError(
            f"pos_dim({pos_dim}) + dir_dim({dir_dim}) != x features ({x.shape[-1]}): for a "
            "conditioned net fold the additional input width into pos_dim, or the "
            "slices silently overlap")
    in_rows = p["positions_pose_input.weight"].shape[1]
    if in_rows != pos_dim:
        raise ValueError(
            f"positions_pose_input expects {in_rows} input rows but pos_dim={pos_dim}: "
            "fold any additional_input_dim prefix into pos_dim")
    kernels, biases, use_x = stack_trunk(p, n_layers, skips, pos_dim, width,
                                         n_stages=int(mesh.shape[axis]))
    positions, directions = x[..., :pos_dim], x[..., x.shape[-1] - dir_dim:]
    o = pipeline_trunk(mesh, kernels, biases, use_x, positions, n_micro, axis)

    def lin(name, h):
        return F.linear(h, p[f"{name}.weight"], p[f"{name}.bias"])

    o = lin("additional_linear_layer", o)
    sigma = lin("sigma_out_layer", o)
    if use_directional_input:
        o = torch.cat([o, directions], -1)
    o = lin("directional_input", o)
    o = torch.relu(lin("directional_net.0", o))
    return torch.cat([lin("rgb_out_layer", o), sigma], -1)
