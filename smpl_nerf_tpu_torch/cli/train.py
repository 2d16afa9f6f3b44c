"""Training entry point (counterpart of smpl_nerf_tpu/cli/train.py).

    python train_torch.py --config=configs/arm_angles.txt --dataset_dir=D [--device cuda]

Same CLI contract as the JAX package's train.py: model_type dispatch, dataset
loading from `<dataset_dir>/train` and `<dataset_dir>/val`, model
construction, solver training, run-dir saving (config.txt + model_*.pt).
Runs on the card unless `--device cpu` asks for the plain PyTorch versions.
Ported for nerf, smpl_nerf, append_to_nerf and append_smpl_params; the
estimator, image-wise, SMPL-model and GIF branches are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch import config as config_mod
from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.pipelines import RenderConfig, _not_ported, build_pipeline
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params
from smpl_nerf_tpu_torch.training.solver import Solver


def _default_log_dir(args) -> str:
    stamp = time.strftime("%b%d_%H-%M-%S")
    return os.path.join("runs", f"{stamp}_{args.experiment_name}")


def train(argv: Optional[Sequence[str]] = None, log_dir: Optional[str] = None,
          device=DEFAULT_DEVICE) -> Solver:
    parser = config_mod.config_parser()
    args = parser.parse_args(argv)
    if args.model_type not in config_mod.MODEL_TYPES:
        raise ValueError("The model type you stated is unknown")
    if args.model_type not in datasets.LOADABLE_MODEL_TYPES:
        raise _not_ported(f"training of model_type {args.model_type!r}")
    if int(getattr(args, "use_gmm_loss", 0)):
        raise _not_ported("--use_gmm_loss (the GMM density prior)")
    dev = resolve_device(device)
    seed = int(getattr(args, "seed", 0))
    np.random.seed(seed)
    torch.manual_seed(seed)

    train_data = datasets.load_dataset(os.path.join(args.dataset_dir, "train"), args.model_type)
    val_data = datasets.load_dataset(os.path.join(args.dataset_dir, "val"), args.model_type)

    models, encoders = build_models_and_params(args, seed=seed, device=dev)
    if args.load_run:
        for name, sd in checkpoints.load_run(args.load_run).items():
            models[name].load_state_dict(sd)
        print("Models loaded from", args.load_run)

    log_dir = log_dir or _default_log_dir(args)
    os.makedirs(log_dir, exist_ok=True)
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders)
    solver = Solver(pipeline, args, log_dir=log_dir, parser=parser)
    if args.load_run:
        solver.restore_train_state(args.load_run)
    solver.train(train_data, val_data)
    checkpoints.save_run(log_dir, solver.eval_params, args, parser)
    print("Run saved under", log_dir)
    return solver


def main(argv: Optional[Sequence[str]] = None) -> Solver:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    own, rest = p.parse_known_args(argv)
    return train(rest, device=own.device)


if __name__ == "__main__":
    main()
