"""Supervised training of the CNN pose regressor (counterpart of
smpl_nerf_tpu/training/estimator.py).

`train_estimator`: MSE between the predicted and the ground-truth angles of
the varied joints (--human_joints), Adam at --lrate, batches of whole images
in a `RandomState(0)` permutation per epoch (the tail that does not fill a
batch is dropped), BatchNorm on batch statistics and dropout while training;
after each epoch the validation loss on running statistics, no dropout. The
run directory gets config.txt and model_smpl_estimator.pt (weights and the
BatchNorm statistics); `load_estimator` reads it back.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch.models.smpl_estimator import SmplEstimator, WIDTHS
from smpl_nerf_tpu_torch.training import checkpoints


def train_estimator(args, parser, train_data, val_data, models: Dict[str, torch.nn.Module],
                    log_dir: Optional[str] = None, writer=None) -> Tuple[dict, dict]:
    """({"smpl_estimator": state_dict}, history with per-epoch train_loss,
    val_loss and seconds; each epoch's losses also go to `writer`, when
    given, as loss/train and loss/val). Runs where the estimator's parameters
    lie."""
    model = models["smpl_estimator"]
    device = next(model.parameters()).device
    joints = [int(j) for j in args.human_joints]
    images = torch.as_tensor(train_data.images, dtype=torch.float32, device=device)
    poses = torch.as_tensor(train_data.human_poses[:, joints], dtype=torch.float32,
                            device=device)
    val_images = torch.as_tensor(val_data.images, dtype=torch.float32, device=device)
    val_poses = torch.as_tensor(val_data.human_poses[:, joints], dtype=torch.float32,
                                device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=float(args.lrate))
    n = images.shape[0]
    bs = min(int(args.batchsize), n)
    np_rng = np.random.RandomState(0)
    history = {"train_loss": [], "val_loss": [], "seconds": []}
    for epoch in range(int(args.num_epochs)):
        t0 = time.perf_counter()
        perm = np_rng.permutation(n)
        model.train()
        losses = []
        for lo in range(0, n - bs + 1, bs):
            idx = torch.as_tensor(perm[lo:lo + bs], device=device)
            optimizer.zero_grad(set_to_none=True)
            loss = torch.mean((model(images[idx]) - poses[idx]) ** 2)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
        model.eval()
        with torch.no_grad():
            vloss = float(torch.mean((model(val_images) - val_poses) ** 2))
        history["train_loss"].append(float(np.mean(losses)))
        history["val_loss"].append(vloss)
        history["seconds"].append(time.perf_counter() - t0)
        print(f"[estimator epoch {epoch}] train {np.mean(losses):.5f} val {vloss:.5f}")
        if writer is not None:
            writer.add_scalar("loss/train", float(np.mean(losses)), epoch)
            writer.add_scalar("loss/val", vloss, epoch)
    final = {"smpl_estimator": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        checkpoints.save_run(log_dir, final, args, parser, args.dataset_dir)
    return final, history


def load_estimator(run_dir: str, device="cpu") -> SmplEstimator:
    """The SmplEstimator of an estimator run directory, in eval mode on
    `device`. Only fc1's input width depends on the image size (the
    product of its two sides over 32), so the module is built from it."""
    sd = checkpoints.load_run(run_dir, required="smpl_estimator")["smpl_estimator"]
    cells = sd["fc1.weight"].shape[1] // WIDTHS[-1]
    model = SmplEstimator(sd["fc2.weight"].shape[0], (32 * cells, 32), device=device)
    model.load_state_dict(sd)
    return model.eval()
