"""Training entry point (counterpart of smpl_nerf_tpu/cli/train.py).

    python train_torch.py --config=configs/arm_angles.txt --dataset_dir=D [--device cuda]

Same CLI contract as the JAX package's train.py: model_type dispatch, dataset
loading from `<dataset_dir>/train` and `<dataset_dir>/val`, model
construction, solver training, run-dir saving (config.txt + model_*.pt).
Runs on the card unless `--device cpu` asks for the plain PyTorch versions.
Every model type trains: image_wise_dynamic through its own trainer
(`training/image_wise.py`) and smpl_estimator through `train_estimator`
(`training/estimator.py`), both routed before a render pipeline is built.
The SMPL-driven families and vertex_sphere get the SMPL model as the JAX
package picks it (`factory.smpl_model_for`: the procedural human unless a
licensed pkl is named) before the splits load, because vertex_sphere's
loader needs it; --use_gmm_loss gets the canonical vertices of that model.

Parallel runs (parallel/): --mesh_shape lays the world's processes out as a
('data', 'model') mesh, --tensor_parallel=1 splits the nets' trunks over its
model axis, and --multihost=1 initialises the process group from torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT, LOCAL_RANK ->
cuda:LOCAL_RANK; `mesh.init_distributed`) where the JAX package calls
jax.distributed.initialize(). One process runs per device:

    torchrun --nproc_per_node=2 train_torch.py --multihost=1 --mesh_shape=2 ...

Every rank trains its rows of each batch; rank 0 names the run dir, logs,
and writes the run (the saves gather tensor-parallel shards on every rank);
the post-training renders split their batches over the data axis. `main`
tears the group down at the end. image_wise_dynamic and smpl_estimator have
trainers of their own that run on one process.

`writer`: where training logs its scalars and per-epoch rerenders
(`Solver`). When the caller passes none, train() makes a SummaryWriter on the
run dir if tensorboardX or torch.utils.tensorboard imports, else logs nothing,
as the JAX package does (image_wise_dynamic gets the caller's writer only, as
in JAX); a writer train() made is closed when it returns. `--check_nans 1`
raises on a non-finite epoch loss with the non-finite parameters
(`solver.nan_report`). `--profile_dir D` runs the solver's training under
torch.profiler (CPU, and CUDA activity on the card) and writes
D/train_trace.json, a Chrome trace that names the program's spans
(`tracing`: solver.step, pass.net, ...); the JAX package writes a
jax.profiler trace there instead.

With `--render_gif` (on by default), a nerf, smpl_nerf or append run then
re-renders its train + val images in creation order into
<run_dir>/img_XXX.png and <run_dir>/inference.gif
(`cli/inference.inference_gif`). One deliberate departure from the JAX
package: JAX catches any exception of this step ("best-effort") and prints
it; here it propagates, after `save_run` has written the run, so that a
kernel that fails in these renders is not hidden.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from smpl_nerf_tpu_torch import config as config_mod
from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.cli.inference import inference_gif
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod
from smpl_nerf_tpu_torch.pipelines import SMPL_MODEL_FAMILIES, RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import (build_models_and_params, dataset_extras,
                                                  smpl_model_for)
from smpl_nerf_tpu_torch.training.solver import Solver


TRACE_FILE = "train_trace.json"
# the families whose run the post-training GIF step re-renders (JAX cli/train.py:132-141)
GIF_FAMILIES = ("append_smpl_params", "append_to_nerf", "nerf", "smpl_nerf")


def _default_log_dir(args) -> str:
    """runs/<stamp>_<experiment_name>, rank 0's name on every rank."""
    stamp = time.strftime("%b%d_%H-%M-%S")
    name = [os.path.join("runs", f"{stamp}_{args.experiment_name}")]
    if mesh_mod.is_distributed():
        dist.broadcast_object_list(name, src=0)
    return name[0]


def summary_writer(log_dir: str):
    """A SummaryWriter on log_dir from tensorboardX or torch.utils.tensorboard,
    or None when neither imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


def train_profiled(solver: Solver, train_data, val_data, profile_dir: str,
                   device: torch.device) -> str:
    """solver.train under torch.profiler, with the program's spans (`tracing`)
    in the trace; returns the Chrome trace's path (rank r > 0 of a process
    group writes train_trace_rank<r>.json beside it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    tracing.enable(0)       # the spans' names go to the trace; none is kept in memory
    try:
        with profile(activities=activities) as prof:
            solver.train(train_data, val_data)
    finally:
        tracing.disable()
    os.makedirs(profile_dir, exist_ok=True)
    name = TRACE_FILE
    if solver.mesh.rank:
        name = name.replace(".json", f"_rank{solver.mesh.rank}.json")
    path = os.path.join(profile_dir, name)
    prof.export_chrome_trace(path)
    print("Profiler trace written to", path)
    return path


def train(argv: Optional[Sequence[str]] = None, log_dir: Optional[str] = None,
          device=DEFAULT_DEVICE, writer=None):
    """The trained Solver; for image_wise_dynamic what `train_image_wise`
    returns (the final state dicts and the per-epoch pose errors), for
    smpl_estimator what `train_estimator` returns (the final state dict and
    the per-epoch losses)."""
    parser = config_mod.config_parser()
    args = parser.parse_args(argv)
    if args.model_type not in config_mod.MODEL_TYPES:
        raise ValueError("The model type you stated is unknown")
    dev = resolve_device(device)
    if int(args.multihost):
        dev = mesh_mod.init_distributed(dev)
    rank0 = mesh_mod.rank() == 0
    seed = int(getattr(args, "seed", 0))
    np.random.seed(seed)
    torch.manual_seed(seed)

    if args.model_type in SMPL_MODEL_FAMILIES:
        smpl_model_for(args)          # on args._smpl_model, which vertex_sphere's loader reads
    train_data, val_data = (datasets.load_dataset(os.path.join(args.dataset_dir, split),
                                                  args.model_type, args, device=dev)
                            for split in ("train", "val"))
    extras = dataset_extras(args, train_data)
    log_dir = log_dir or _default_log_dir(args)

    if args.model_type in ("image_wise_dynamic", "smpl_estimator") and mesh_mod.world_size() > 1:
        raise ValueError(f"{args.model_type} trains on one process; the world has "
                         f"{mesh_mod.world_size()}")
    if args.model_type == "image_wise_dynamic":
        from smpl_nerf_tpu_torch.training.image_wise import train_image_wise
        return train_image_wise(args, parser, train_data, val_data, extras, log_dir,
                                device=dev, writer=writer)

    models, encoders = build_models_and_params(args, seed=seed, device=dev, extras=extras)
    if args.load_run:
        required = "smpl_estimator" if args.model_type == "smpl_estimator" else "model_coarse"
        for name, sd in checkpoints.load_run(args.load_run, required).items():
            models[name].load_state_dict(sd)
        print("Models loaded from", args.load_run)

    os.makedirs(log_dir, exist_ok=True)
    own_writer = writer is None and rank0      # rank 0 logs
    if own_writer:
        writer = summary_writer(log_dir)
    try:
        return _train_models(args, parser, train_data, val_data, extras, models, encoders,
                             log_dir, dev, writer)
    finally:
        if own_writer and writer is not None:
            writer.close()


def _train_models(args, parser, train_data, val_data, extras, models, encoders,
                  log_dir: str, dev: torch.device, writer):
    if args.model_type == "smpl_estimator":
        # supervised CNN training has no render pipeline: routed before one is built
        from smpl_nerf_tpu_torch.training.estimator import train_estimator
        return train_estimator(args, parser, train_data, val_data, models, log_dir, writer)
    cfg = RenderConfig.from_args(args)
    pipeline = build_pipeline(cfg, models, encoders, extras)
    canonical_vertices = None
    if cfg.use_gmm_loss and ("smpl_model" in extras or train_data.betas is not None):
        # the density prior's means: the SMPL model's vertices at the zero pose
        canonical_vertices = smpl_mod.smpl_forward(
            smpl_model_for(args), extras["betas"], torch.zeros(69, device=dev))
    solver = Solver(pipeline, args, log_dir=log_dir, parser=parser,
                    canonical_vertices=canonical_vertices, writer=writer)
    if args.load_run:
        solver.restore_train_state(args.load_run)
    if args.profile_dir:
        train_profiled(solver, train_data, val_data, args.profile_dir, dev)
    else:
        solver.train(train_data, val_data)
    solver.save_run(log_dir, args.dataset_dir)
    if solver.mesh.rank == 0:
        print("Run saved under", log_dir)
    if int(args.render_gif) and args.model_type in GIF_FAMILIES:
        # the reference renders the whole train + val distribution after
        # training (train.py:183,203 -> inference.py:35-110)
        inference_gif(log_dir, args, train_data, val_data, device=dev)
    return solver


def main(argv: Optional[Sequence[str]] = None) -> Solver:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    own, rest = p.parse_known_args(argv)
    try:
        return train(rest, device=own.device)
    finally:
        mesh_mod.destroy()


if __name__ == "__main__":
    main()
