"""The parallel layer run per rank (counterpart of __graft_entry__.dryrun_multichip).

    python -m smpl_nerf_tpu_torch.parallel.dryrun --rank R --world N \\
        --init_method file:///tmp/rendezvous --out DIR [--inputs DIR --cases dp,cli,...]
    torchrun --nproc_per_node=N -m smpl_nerf_tpu_torch.parallel.dryrun --out DIR

Without --cases each rank runs `dryrun_multichip`: a data-parallel train step
of a tiny smpl_nerf over the whole world, a tensor-parallel one on a
(world/2, 2) mesh when the world is even, and the sample axis, the pipelined
trunk and the expert routing over a (1, world) mesh, each against its dense
form (a mismatch raises). With --cases it runs the named cases on the inputs
that `--inputs` holds (a dataset under data/, initial weights under init/,
inputs.npz) and writes DIR/<case>_rank<r>.npz for a caller to compare:

  dp        a 2-step coarse+fine nerf run on mesh '2', no jitter or noise;
  cli       the same through cli/train with --multihost=1, jitter and
            sigma noise on (drawn for the global batch);
  tp_fused  mesh '1,2', --tensor_parallel=1 --use_fused_mlp=2 in bf16;
  tp, repl  mesh '2,2' with and without --tensor_parallel=1, no jitter;
  resume    restore_train_state where only rank 0's run dir holds the state,
            then where no rank's does;
  axes      sample_parallel_raw2outputs, pipeline_trunk / pp_render_ray_net
            (gradients too) and expert_parallel_apply (overflow, gradients)
            over mesh '1,world', and the shape guards.

Every rank runs on its card (cuda:LOCAL_RANK, NCCL) unless --device cpu
asks for the host (gloo, the tests); without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch import config as config_mod
from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.core import integrate
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.parallel import ep, pp, sample_axis
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params, dataset_extras
from smpl_nerf_tpu_torch.training.solver import Solver

# the training cases' flags: a 2-step coarse+fine nerf at netdepth 3, width 16
BASE_FLAGS = ["--config=/dev/null", "--model_type=nerf", "--netdepth=3", "--netwidth=16",
              "--netdepth_fine=3", "--netwidth_fine=16", "--skips=1",
              "--number_coarse_samples=4", "--number_fine_samples=4", "--run_fine=1",
              "--number_frequencies_postitional=2", "--number_frequencies_directional=1",
              "--batchsize=32", "--batchsize_val=100", "--num_epochs=2", "--steps_per_epoch=1",
              "--use_pallas=1", "--sigma_noise_std=0", "--number_validation_images=0",
              "--render_gif=0"]
CASE_FLAGS = {
    "dp": ["--mesh_shape=2"],
    "cli": ["--mesh_shape=2", "--sigma_noise_std=1", "--multihost=1"],
    "tp_fused": ["--mesh_shape=1,2", "--tensor_parallel=1", "--use_fused_mlp=2",
                 "--compute_dtype=bfloat16"],
    "tp": ["--mesh_shape=2,2", "--tensor_parallel=1"],
    "repl": ["--mesh_shape=2,2"],
}
# the cases that train without jitter or sigma noise (a generator of None)
DETERMINISTIC = ("dp", "tp", "repl")


def case_argv(flags: Sequence[str], dataset_dir: str, load_run: Optional[str] = None) -> List[str]:
    return (BASE_FLAGS + list(flags) + [f"--dataset_dir={dataset_dir}"]
            + ([f"--load_run={load_run}"] if load_run else []))


class NullWriter:
    """A writer that drops what it is given (no tensorboard import)."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def build_solver(argv: Sequence[str], device="cpu", log_dir: Optional[str] = None):
    """(Solver, train split, val split) as cli/train builds them, with the
    weights of --load_run when it is given."""
    parser = config_mod.config_parser()
    args = parser.parse_args(list(argv))
    dev = torch.device(device)
    train_data, val_data = (datasets.load_dataset(os.path.join(args.dataset_dir, split),
                                                  args.model_type, args, device=dev)
                            for split in ("train", "val"))
    extras = dataset_extras(args, train_data)
    models, encoders = build_models_and_params(args, seed=int(args.seed), device=dev,
                                               extras=extras)
    if args.load_run:
        for name, sd in checkpoints.load_run(args.load_run).items():
            models[name].load_state_dict(sd)
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
    return Solver(pipeline, args, log_dir=log_dir, parser=parser), train_data, val_data


def train_case(argv: Sequence[str], device="cpu", deterministic: bool = False,
               log_dir: Optional[str] = None) -> Solver:
    """Train as `build_solver` builds; deterministic: no jitter, no sigma noise."""
    solver, train_data, val_data = build_solver(argv, device, log_dir)
    if deterministic:
        solver.generator = None
    solver.train(train_data, val_data)
    return solver


def solver_result(solver: Solver) -> Dict[str, np.ndarray]:
    """Histories, whole weights (w/<model>/<key>) and the local shape of the
    coarse net's first layer (a shard under tensor parallelism)."""
    out = {k: np.asarray(v, np.float64) for k, v in solver.history.items()}
    whole = checkpoints._host_tree(solver.raw_state_dicts(), solver.mesh, solver.tp_dims)
    for name, sd in whole.items():
        for key, value in sd.items():
            out[f"w/{name}/{key}"] = value.float().numpy()
    out["local_first_shape"] = np.asarray(
        solver.models["model_coarse"].positions_pose_input.weight.shape)
    return out


# --------------------------------------------------------------------- cases

def _case_resume(inputs: str, out: str, rank: int) -> Dict[str, np.ndarray]:
    """Rank 0 resumes from the cli case's run dir, the others from an empty
    dir; then every rank from an empty one."""
    src = os.path.join(out, "cli_run")
    empty = os.path.join(out, f"empty_rank{rank}")
    os.makedirs(empty, exist_ok=True)
    solver, _, _ = build_solver(case_argv(CASE_FLAGS["cli"], os.path.join(inputs, "data")))
    restored = solver.restore_train_state(src if rank == 0 else empty)
    state = solver.optimizer.optimizer.state_dict()["state"]
    moments = float(sum(v["exp_avg"].abs().sum() for v in state.values())) if state else 0.0
    fresh, _, _ = build_solver(case_argv(CASE_FLAGS["cli"], os.path.join(inputs, "data")))
    none = fresh.restore_train_state(empty)
    return {"restored": np.asarray(restored), "epoch_offset": np.asarray(solver.epoch_offset),
            "best_val": np.asarray(solver.best_val), "moments": np.asarray(moments),
            "restored_none": np.asarray(none)}


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _case_axes(inputs: str, device="cpu") -> Dict[str, np.ndarray]:
    """The sample axis, the pipeline and the experts over mesh '1,world'."""
    world = mesh_mod.world_size()
    mesh = mesh_mod.make_mesh(f"1,{world}", device)
    z = np.load(os.path.join(inputs, "inputs.npz"))
    t = {k: torch.as_tensor(z[k], device=device) for k in z.files}
    res: Dict[str, np.ndarray] = {}
    # sample axis: this rank's block of S
    dists = sample_axis.global_dists(t["sa_z"], t["sa_dirs"])
    got = sample_axis.sample_parallel_raw2outputs(
        mesh, sample_axis.segment(t["sa_raw"], mesh), sample_axis.segment(t["sa_z"], mesh),
        sample_axis.segment(dists, mesh))
    for k in ("rgb", "weights", "density", "depth", "acc"):
        res[f"sa_{k}"] = getattr(got, k).cpu().numpy()
    seg = integrate.raw2outputs_segmented(
        sample_axis.segment(t["sa_raw"], mesh), sample_axis.segment(t["sa_z"], mesh),
        t["sa_dirs"], 2, white_background=True, group=mesh.model_group)
    res["seg_rgb"], res["seg_weights"] = seg.rgb.cpu().numpy(), seg.weights.cpu().numpy()
    # pipeline: the stacked trunk at world stages, and the whole net
    net = RenderRayNet(8, 16, 6, 4, skips=(4,), device=device)
    net.load_state_dict({k[3:]: t[k] for k in z.files if k.startswith("pp/")})
    x, tgt = t["pp_x"], t["pp_tgt"]
    for n_micro in (1, 4):
        k, b, u = pp.stack_trunk(net, 8, (4,), 6, 16, n_stages=world)
        k.retain_grad()
        y = pp.pipeline_trunk(mesh, k, b, u, x[:, :6], n_micro)
        (y ** 2).mean().backward()
        res[f"trunk_out_{n_micro}"] = y.detach().cpu().numpy()
        res[f"trunk_dk_{n_micro}"] = k.grad.cpu().numpy()
        net.zero_grad()
        out = pp.pp_render_ray_net(mesh, net, x, n_layers=8, width=16, pos_dim=6, dir_dim=4,
                                   n_micro=n_micro)
        ((out - tgt) ** 2).mean().backward()
        res[f"pp_out_{n_micro}"] = out.detach().cpu().numpy()
        for key, p in net.named_parameters():
            res[f"pp_grad_{n_micro}/{key}"] = p.grad.cpu().numpy()
        net.zero_grad()
    k, b, u = pp.stack_trunk(net, 8, (4,), 6, 16, n_stages=1)
    res["guard_micro"] = np.asarray(_raises(
        lambda: pp.pipeline_trunk(mesh, k, b, u, x[:, :6], n_micro=3)))
    res["guard_layers"] = np.asarray(_raises(
        lambda: pp.pipeline_trunk(mesh, k[:7], b[:7], u[:7], x[:, :6], n_micro=4)))
    res["guard_dims"] = np.asarray(_raises(
        lambda: pp.pp_render_ray_net(mesh, net, x, n_layers=8, width=16, pos_dim=6,
                                     dir_dim=3)))
    # experts: this rank's block of the tokens
    experts = ep.ExpertMLP(*(t[f"ep_{w}"].clone().requires_grad_(True)
                             for w in ("w0", "b0", "w1", "b1")))
    n = t["ep_x"].shape[0]
    lo, hi = mesh.model_index * n // world, (mesh.model_index + 1) * n // world
    r = ep.expert_parallel_apply(mesh, experts, t["ep_x"][lo:hi], t["ep_ids"][lo:hi],
                                 capacity=n // world)
    res["ep_out"], res["ep_overflow"] = r.out.detach().cpu().numpy(), r.overflow.cpu().numpy()
    (((r.out - t["ep_tgt"][lo:hi]) ** 2).sum() / t["ep_tgt"].numel()).backward()
    for w, g in zip(("w0", "b0", "w1", "b1"), experts):
        res[f"ep_grad_{w}"] = g.grad.cpu().numpy()
    zero = torch.zeros_like(t["ep_ids"][lo:hi])
    r0 = ep.expert_parallel_apply(mesh, experts, t["ep_x"][lo:hi], zero, capacity=2)
    res["ep0_out"], res["ep0_overflow"] = r0.out.detach().cpu().numpy(), r0.overflow.cpu().numpy()
    res["guard_mesh"] = np.asarray(_raises(lambda: mesh_mod.make_mesh("1", device)))
    odd = ep.ExpertMLP(*(w[:2 * world - 1] for w in experts))
    res["guard_experts"] = np.asarray(_raises(
        lambda: ep.expert_parallel_apply(mesh, odd, t["ep_x"][lo:hi], t["ep_ids"][lo:hi], 8)))
    return res


def run_cases(cases: Sequence[str], inputs: str, out: str, device="cpu") -> None:
    from smpl_nerf_tpu_torch.cli import train as train_cli
    rank = mesh_mod.rank()
    data, init = os.path.join(inputs, "data"), os.path.join(inputs, "init")
    for case in cases:
        if case == "resume":
            res = _case_resume(inputs, out, rank)
        elif case == "axes":
            res = _case_axes(inputs, device)
        elif case == "cli":
            solver = train_cli.train(case_argv(CASE_FLAGS[case], data, init),
                                     log_dir=os.path.join(out, "cli_run"), device=device,
                                     writer=NullWriter())
            res = solver_result(solver)
        else:
            solver = train_case(case_argv(CASE_FLAGS[case], data, init), device,
                                deterministic=case in DETERMINISTIC)
            solver.save_run(os.path.join(out, f"{case}_run"))
            res = solver_result(solver)
        np.savez(os.path.join(out, f"{case}_rank{rank}.npz"), **res)
        print(f"CASE_OK {case} rank={rank}", flush=True)


# ------------------------------------------------------------ self-checking

def _tiny_smpl_nerf_solver(mesh_shape: str, device, extra: Sequence[str] = ()):
    n = mesh_mod.world_size()
    parser = config_mod.config_parser()
    args = parser.parse_args([
        "--config=/dev/null", "--model_type=smpl_nerf", "--human_pose_encoding=1",
        "--netdepth=2", "--netwidth=32", "--netdepth_fine=2", "--netwidth_fine=32",
        "--netwidth_warp=16", "--number_coarse_samples=8", "--number_fine_samples=8",
        "--number_frequencies_postitional=4", "--number_frequencies_directional=2",
        "--number_frequencies_pose=2", "--sigma_noise_std=0", "--use_pallas=0",
        f"--batchsize={8 * n}", f"--batchsize_val={8 * n}", "--num_epochs=1",
        "--steps_per_epoch=1", f"--mesh_shape={mesh_shape or ''}", *extra])
    models, encoders = build_models_and_params(args, seed=0, device=device)
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, {})
    mesh = mesh_mod.make_mesh(mesh_shape, device) if mesh_shape is not None else mesh_mod.Mesh()
    return Solver(pipeline, args, mesh=mesh)


def _tiny_rays(n_rays: int) -> datasets.RayData:
    rng = np.random.RandomState(0)
    h = w = 4
    n_img = n_rays // (h * w)
    return datasets.RayData(
        origins=np.tile(np.asarray([[0.0, 0.0, 2.4]], np.float32), (n_rays, 1)),
        directions=rng.uniform(-0.3, 0.3, (n_rays, 3)).astype(np.float32),
        rgb=rng.rand(n_rays, 3).astype(np.float32),
        image_indices=np.repeat(np.arange(n_img, dtype=np.int32), h * w),
        h=h, w=w, focal=4.0, num_images=n_img,
        camera_transforms=np.tile(np.eye(4, dtype=np.float32), (n_img, 1, 1)),
        human_poses=np.zeros((n_img, 69), np.float32))


def dryrun_multichip(device="cpu") -> None:
    """DP, TP, the sample axis, PP and EP at the world's size, each against
    its dense form on this rank; raises on a mismatch."""
    n = mesh_mod.world_size()
    rank = mesh_mod.rank()
    data = _tiny_rays(16 * n)

    def trained(mesh_shape, extra=()):
        solver = _tiny_smpl_nerf_solver(mesh_shape, device, extra)
        solver.train(data, data)
        return solver

    fused = ("--use_fused_mlp=2", "--compute_dtype=bfloat16")
    runs = [("", ())]
    if n % 2 == 0:      # tensor parallel, also with kernels B and C on the gathered nets
        runs += [(f"{n // 2},2", ("--tensor_parallel=1",)),
                 (f"{n // 2},2", ("--tensor_parallel=1", *fused))]
    rtol = 1e-4         # the training runs' bound (summation order over the data axis)
    dense = {}
    for shape, extra in runs:
        mode = tuple(e for e in extra if e in fused)
        if mode not in dense:
            dense[mode] = trained(None, mode)
        got = trained(shape, extra)
        have, want = (np.concatenate([s.history["train_loss"], s.history["val_loss"]])
                      for s in (got, dense[mode]))
        worst = float(np.max(np.abs(have - want) / np.abs(want)))
        np.testing.assert_allclose(have, want, rtol=rtol)
        print(f"dryrun_multichip({n}) rank {rank}: OK, a train step on mesh "
              f"'{shape or n}'{''.join(' ' + e for e in extra)} equals the single-device "
              f"step (loss max rel {worst:.3e}, bound {rtol})", flush=True)
    mesh = mesh_mod.make_mesh(f"1,{n}", device)
    rng = np.random.RandomState(0)
    R, S = 8, 8 * n
    raw = torch.as_tensor(rng.randn(R, S, 4).astype(np.float32), device=device)
    z = torch.sort(torch.as_tensor(rng.uniform(1, 4, (R, S)).astype(np.float32),
                                   device=device), -1)[0]
    dirs = torch.as_tensor(rng.randn(R, 3).astype(np.float32), device=device)
    got = sample_axis.sample_parallel_raw2outputs(
        mesh, sample_axis.segment(raw, mesh), sample_axis.segment(z, mesh),
        sample_axis.segment(sample_axis.global_dists(z, dirs), mesh))
    want = integrate.raw2outputs(raw, z, dirs)
    torch.testing.assert_close(got.rgb, want.rgb, atol=1e-4, rtol=1e-4)
    net = RenderRayNet(8, 32, 12, 6, generator=torch.Generator().manual_seed(1),
                       device=device)
    x = torch.as_tensor(rng.randn(32, 18).astype(np.float32), device=device)
    out = pp.pp_render_ray_net(mesh, net, x, n_layers=8, width=32, pos_dim=12, dir_dim=6)
    torch.testing.assert_close(out, net(x), atol=1e-4, rtol=1e-4)
    experts = ep.init_experts(torch.Generator(device=device).manual_seed(0), 2 * n, 6, 8, 4)
    xt = torch.as_tensor(rng.randn(8 * n, 6).astype(np.float32), device=device)
    ids = torch.as_tensor(rng.randint(0, 2 * n, 8 * n), device=device)
    lo, hi = mesh.model_index * 8, (mesh.model_index + 1) * 8
    r = ep.expert_parallel_apply(mesh, experts, xt[lo:hi], ids[lo:hi], capacity=8)
    torch.testing.assert_close(r.out, ep.expert_apply(experts, xt, ids)[lo:hi],
                               atol=1e-4, rtol=1e-4)
    print(f"dryrun_multichip({n}) rank {rank}: OK, the sample axis, the "
          f"{n}-stage pipeline and the experts equal their dense forms", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, default=None, help="default: $RANK (torchrun)")
    p.add_argument("--world", type=int, default=None, help="default: $WORLD_SIZE")
    p.add_argument("--init_method", default="env://")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default; each rank on cuda:LOCAL_RANK) or cpu")
    p.add_argument("--out", default=".")
    p.add_argument("--inputs", default=None)
    p.add_argument("--cases", default="")
    a = p.parse_args(argv)
    device = mesh_mod.init_distributed(resolve_device(a.device), a.init_method, a.rank,
                                       a.world)
    try:
        os.makedirs(a.out, exist_ok=True)
        if a.cases:
            run_cases(a.cases.split(","), a.inputs, a.out, device)
        else:
            dryrun_multichip(device)
    finally:
        mesh_mod.destroy()


if __name__ == "__main__":
    main()
