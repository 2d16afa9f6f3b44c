"""Training solver (counterpart of smpl_nerf_tpu/training/solver.py).

One train step (loss, backward, Adam with parameter groups, optional EMA) and
a thin epoch loop: seeded ray permutation, wrap-around batches, optional
foreground oversampling, masked validation over the whole val split, a
per-epoch run-dir save with `val_curve.json`, the resume state and the
best-validation snapshot.

  * loss = MSE(rgb_coarse) + MSE(rgb_fine),
  * Adam / AdamW with the reference's groups: `net` on --lrate, `pose`
    (estimator parameters) on --lrate_pose, `frozen`; a group whose learning
    rate is 0 is left out of the optimizer, so it does not move at all,
  * --lrate_decay k: lr * 0.1^(step / (k * 1000)), the step counted from 0.

The dataset arrays go to the device once; a batch is an index gather. Where
the JAX package compiles a step (and, with --scan_steps, several) into one
program, this steps eagerly, one batch at a time. Not ported yet: the GMM
density prior, the supervised `warp` loss, --images_per_batch, the pose table
swap of the dynamic families, per-epoch re-render logging, tensor/mesh/
multi-host parallelism and --check_nans.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch.pipelines import Pipeline
from smpl_nerf_tpu_torch.training import checkpoints


def mse2psnr(mse: float) -> float:
    return -10.0 * np.log10(mse)


def foreground_split(rgb: np.ndarray, num_images: int, h: int, w: int,
                     white_background: bool, tol: float = 0.02) -> Optional[np.ndarray]:
    """Classify each ray as foreground/background from its target colour.

    With a white background the background colour is known; otherwise each
    image's border pixels vote for its background colour (their median).
    Returns a bool [n] mask, or None (with a warning) when most rays come out
    as foreground: the background is then not flat and oversampling would be
    noise, so callers fall back to uniform sampling.
    """
    n = rgb.shape[0]
    if white_background:
        is_fg = np.any(np.abs(rgb - 1.0) > tol, axis=-1)
    elif num_images * h * w == n:
        imgs = rgb.reshape(num_images, h, w, 3)
        border = np.zeros((h, w), bool)
        border[0, :] = border[-1, :] = True
        border[:, 0] = border[:, -1] = True
        med = np.median(imgs[:, border], axis=1)        # [N_img, 3]
        dev = np.abs(imgs - med[:, None, None, :]).max(-1)
        is_fg = (dev > tol).reshape(-1)
    else:  # rays don't tile images
        is_fg = np.any(np.abs(rgb - rgb[0][None]) > tol, axis=-1)
    frac = float(is_fg.mean())
    if frac > 0.6:
        print(f"WARNING: foreground split looks degenerate ({frac:.0%} of rays classified "
              "foreground): the background is probably not flat; disabling "
              "--foreground_sample_ratio oversampling (uniform ray sampling).")
        return None
    return is_fg


def gather_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor) -> dict:
    """Gather a ray batch from device-resident dataset arrays.

    Keys ending in '_table' are per-IMAGE arrays (e.g. 'human_pose_table'
    [N_img, 69]); they are mapped through the gathered image_indices, so the
    pipeline sees a per-ray key ('human_pose' [R, 69]) without the dataset
    ever holding per-ray duplicates.
    """
    batch = {k: v[idx] for k, v in arrays.items() if not k.endswith("_table")}
    for k, v in arrays.items():
        if k.endswith("_table"):
            batch[k[:-len("_table")]] = v[batch["image_indices"].long()]
    return batch


def make_loss_fn(pipeline: Pipeline) -> Callable:
    """Loss = MSE(coarse) + MSE(fine)."""

    def loss_fn(batch, generator=None, train: bool = True, mask=None):
        """mask: optional [R] 0/1 weights: the masked MEAN over real rays only
        (validation pads short batches; padded rays must not bias the loss
        that drives best-checkpoint selection)."""
        if mask is None:
            _mean = torch.mean
        else:
            def _mean(x):
                per_ray = x.reshape(x.shape[0], -1).mean(-1)
                return torch.sum(per_ray * mask) / torch.clamp(torch.sum(mask), min=1.0)
        out = pipeline(batch, generator, train)
        rgb_truth = batch["rgb"]
        loss_c = _mean((out["rgb_coarse"] - rgb_truth) ** 2)
        loss_f = _mean((out["rgb_fine"] - rgb_truth) ** 2)
        loss = loss_c + loss_f
        return loss, {"loss_coarse": loss_c, "loss_fine": loss_f, "loss": loss}

    return loss_fn


class GroupedOptimizer:
    """Adam over the parameter groups that train, with each group's decay.

    `step()` applies one optimizer step and then advances the schedule, so the
    first step runs at the undecayed rate (the step is counted from 0).
    """

    def __init__(self, optimizer: Optional[torch.optim.Optimizer],
                 scheduler: Optional[torch.optim.lr_scheduler.LambdaLR], labels: Dict[str, str]):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.labels = labels          # model name -> group label

    def zero_grad(self) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.optimizer is not None:
            self.optimizer.step()
            self.scheduler.step()

    def state_dict(self) -> dict:
        if self.optimizer is None:
            return {}
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if self.optimizer is not None and state:
            self.optimizer.load_state_dict(state["optimizer"])
            self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(models: Dict[str, torch.nn.Module], args, model_type: str,
                   frozen_nerf: bool = False) -> GroupedOptimizer:
    """Adam with parameter-group learning rates mirroring the reference solvers."""
    lrate = float(args.lrate)
    lrate_pose = float(args.lrate_pose)
    wd = float(getattr(args, "weight_decay", 0) or 0)
    decay_k = int(getattr(args, "lrate_decay", 0) or 0)
    pose_decay_k = int(getattr(args, "lrate_pose_decay", 0) or 0)

    def label(name: str) -> str:
        if name == "smpl_estimator":
            return "pose"
        if frozen_nerf and name in ("model_coarse", "model_fine"):
            return "frozen"
        return "net"

    labels = {name: label(name) for name in models}
    rates = {"net": (lrate, decay_k), "pose": (lrate_pose, pose_decay_k or decay_k),
             "frozen": (0.0, 0)}
    groups, decays = [], []
    for group, (lr, dk) in rates.items():
        params = [p for name, m in models.items() if labels[name] == group
                  for p in m.parameters() if p.requires_grad]
        if not params or lr == 0.0:     # lr 0: the parameters must not move at all
            continue
        groups.append({"params": params, "lr": lr})
        decays.append(dk)
    if not groups:
        return GroupedOptimizer(None, None, labels)
    if wd > 0:
        optimizer = torch.optim.AdamW(groups, lr=lrate, weight_decay=wd)
    else:
        optimizer = torch.optim.Adam(groups, lr=lrate)
    # original-NeRF schedule: lr * 0.1^(step / (dk * 1000))
    lambdas = [(lambda step, dk=dk: 0.1 ** (step / (dk * 1000.0))) if dk > 0
               else (lambda step: 1.0) for dk in decays]
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)
    return GroupedOptimizer(optimizer, scheduler, labels)


class Solver:
    """Epoch loop over the train step.

    Handles: per-epoch ray permutation, early validation every log_iterations,
    masked validation over the whole val split, metric history, and per-epoch
    checkpointing with the best-validation snapshot under `best/`.
    """

    def __init__(self, pipeline: Pipeline, args, log_dir: Optional[str] = None,
                 parser=None, frozen_nerf: bool = False):
        self.pipeline = pipeline
        self.models = pipeline.models
        self.args = args
        self.parser = parser
        self.log_dir = log_dir
        self.device = next(self.models["model_coarse"].parameters()).device
        for model in self.models.values():
            model.requires_grad_(True)
        self.loss_fn = make_loss_fn(pipeline)
        self.optimizer = make_optimizer(self.models, args, args.model_type, frozen_nerf)
        self.global_step = 0
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        # resume accounting (restore_train_state): epoch numbering continues
        # and the best-val snapshot of before the resume is never overwritten
        # by a worse later epoch
        self.epoch_offset = 0
        self.best_val = float("inf")
        self.val_curve = []  # per-epoch metrics, persisted as val_curve.json
        self.step_seconds = []  # host-clock seconds of every train step (synchronised)

        # --param_ema: exponential moving average of the weights, used for
        # validation and checkpoints; the raw weights keep training
        self.ema_decay = float(getattr(args, "param_ema", 0) or 0)
        self.ema_params = ({name: {k: v.detach().clone() for k, v in m.named_parameters()}
                            for name, m in self.models.items()}
                           if self.ema_decay > 0 else None)
        # jitter and sigma noise: one generator on the device, seeded from --seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(getattr(args, "seed", 0)))

    # ----------------------------------------------------------- weights
    def raw_state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: m.state_dict() for name, m in self.models.items()}

    @property
    def eval_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Weights used for validation / rendering / checkpoints: the EMA
        shadow when --param_ema is on, the raw training weights otherwise."""
        return self.ema_params if self.ema_params is not None else self.raw_state_dicts()

    @contextlib.contextmanager
    def _eval_weights(self):
        """The modules hold `eval_params` inside the block (a no-op without EMA)."""
        if self.ema_params is None:
            yield
            return
        stash = {name: {k: v.detach().clone() for k, v in m.named_parameters()}
                 for name, m in self.models.items()}
        self._load(self.ema_params)
        try:
            yield
        finally:
            self._load(stash)

    @torch.no_grad()
    def _load(self, params: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for name, model in self.models.items():
            for key, p in model.named_parameters():
                p.copy_(params[name][key])

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.ema_decay
        for name, model in self.models.items():
            for key, p in model.named_parameters():
                self.ema_params[name][key].mul_(d).add_(p.detach(), alpha=1.0 - d)

    # -------------------------------------------------------------- steps
    def train_step(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        """grad -> optimizer update (-> EMA); returns the loss terms."""
        self.optimizer.zero_grad()
        loss, aux = self.loss_fn(batch, generator, True)
        loss.backward()
        self.optimizer.step()
        if self.ema_params is not None:
            self._update_ema()
        return {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def eval_step(self, batch, mask=None) -> dict:
        _, aux = self.loss_fn(batch, None, False, mask)
        return aux

    def device_arrays(self, data, model_type: str) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in data.batch_arrays(model_type).items()}

    def gather(self, arrays, idx: np.ndarray) -> dict:
        return gather_batch(arrays, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                                    device=self.device))

    # -------------------------------------------------------------- resume
    def save_train_state(self, run_dir: str, epoch: int, best_val: float) -> None:
        checkpoints.save_train_state(
            run_dir, self.optimizer.state_dict(), self.ema_params, epoch,
            raw_params=self.raw_state_dicts() if self.ema_params is not None else None,
            best_val=best_val)

    def restore_train_state(self, run_dir: str) -> bool:
        """Restore optimizer moments (+ EMA shadow + raw weights + epoch and
        best-val accounting) saved by save_train_state; False when the run
        directory has none (weights-only resume)."""
        state = checkpoints.load_train_state(run_dir, self.device)
        if state is None:
            return False
        self.optimizer.load_state_dict(state["optimizer"])
        if state.get("ema") is not None and self.ema_params is not None:
            for name, params in self.ema_params.items():
                for key, value in params.items():
                    value.copy_(state["ema"][name][key])
        if state.get("raw") is not None:
            # with --param_ema the run dir's weights are the EMA shadow; the
            # moments belong to the raw training weights stored beside them
            for name, model in self.models.items():
                model.load_state_dict(state["raw"][name])
        if state.get("epoch") is not None:
            self.epoch_offset = int(state["epoch"]) + 1
        if state.get("best_val") is not None:
            self.best_val = float(state["best_val"])
        print("Optimizer state restored from", run_dir,
              f"(epoch {state.get('epoch')}, best val {state.get('best_val')})")
        return True

    # ---------------------------------------------------------------- train
    def train(self, train_data, val_data, callback: Optional[Callable] = None):
        args = self.args
        model_type = args.model_type
        seed = int(getattr(args, "seed", 0))
        arrays = self.device_arrays(train_data, model_type)
        val_arrays = self.device_arrays(val_data, model_type)
        n = train_data.num_rays
        bs = int(args.batchsize)
        steps_per_epoch = int(getattr(args, "steps_per_epoch", 0)) or max(1, n // bs)
        # resumed runs continue the global-step / epoch numbering
        self.global_step = max(self.global_step, self.epoch_offset * steps_per_epoch)
        early_val = bool(int(getattr(args, "early_validation", 0)))
        np_rng = np.random.RandomState(seed)

        # foreground-weighted ray sampling (0 = the reference's uniform sampling)
        fg_ratio = float(getattr(args, "foreground_sample_ratio", 0.0) or 0.0)
        fg_idx = bg_idx = None
        if fg_ratio > 0.0:
            is_fg = foreground_split(np.asarray(train_data.rgb), train_data.num_images,
                                     train_data.h, train_data.w,
                                     bool(int(getattr(args, "white_background", 0))))
            fg_idx = None if is_fg is None else np.where(is_fg)[0]
            bg_idx = None if is_fg is None else np.where(~is_fg)[0]
            if fg_idx is None or len(fg_idx) == 0 or len(bg_idx) == 0:
                fg_ratio, fg_idx, bg_idx = 0.0, None, None
            else:
                print(f"foreground sampling: {len(fg_idx)}/{n} fg rays, ratio {fg_ratio}")

        def draw_batch_indices():
            n_fg = int(bs * fg_ratio)
            fg = fg_idx[np_rng.randint(0, len(fg_idx), n_fg)]
            bg = bg_idx[np_rng.randint(0, len(bg_idx), bs - n_fg)]
            return np.concatenate([fg, bg])

        for epoch in range(int(args.num_epochs)):
            perm = np_rng.permutation(n)
            epoch_losses = []
            t0 = time.time()
            for step in range(steps_per_epoch):
                if fg_ratio > 0.0:
                    idx = draw_batch_indices()
                else:
                    lo = (step * bs) % max(1, n - bs + 1) if n >= bs else 0
                    idx = perm[lo:lo + bs]
                    if len(idx) < bs:  # wrap around for tiny datasets
                        idx = np.concatenate([idx, perm[:bs - len(idx)]])
                t_step = time.perf_counter()
                aux = self.train_step(self.gather(arrays, idx), self.generator)
                epoch_losses.append(float(aux["loss"]))   # synchronises the device
                self.step_seconds.append(time.perf_counter() - t_step)
                self.global_step += 1
                if early_val and step % int(args.log_iterations) == 0:
                    self.history.setdefault("val_loss_early", []).append(
                        self._validate(val_arrays, val_data.num_rays, epoch=self.global_step))
            self.history.setdefault("step_loss", []).extend(epoch_losses)
            train_loss = float(np.mean(epoch_losses))
            val_loss = self._validate(val_arrays, val_data.num_rays,
                                      epoch=self.epoch_offset + epoch,
                                      full=epoch == int(args.num_epochs) - 1)
            dt = time.time() - t0
            rays_per_sec = steps_per_epoch * bs / dt
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            print(f"[epoch {self.epoch_offset + epoch}] train {train_loss:.5f} "
                  f"val {val_loss:.5f} psnr {mse2psnr(max(val_loss / 2, 1e-10)):.2f} "
                  f"({rays_per_sec:,.0f} rays/s)")
            if callback is not None:
                callback(self, epoch)
            if self.log_dir:
                checkpoints.save_run(self.log_dir, self.eval_params, args, self.parser)
                # machine-readable per-epoch curve (absolute epoch numbering
                # survives --load_run resumes)
                self.val_curve.append({
                    "epoch": self.epoch_offset + epoch,
                    "train_loss": float(train_loss), "val_loss": float(val_loss),
                    "psnr_estimate": float(mse2psnr(max(val_loss / 2, 1e-10))),
                    "rays_per_sec": round(rays_per_sec, 1)})
                with open(os.path.join(self.log_dir, "val_curve.json"), "w") as fh:
                    json.dump(self.val_curve, fh, indent=1)
                # full-fidelity resume state: a run cut mid-way resumes
                # without restarting Adam cold
                self.save_train_state(self.log_dir, self.epoch_offset + epoch,
                                      min(self.best_val, val_loss))
                # keep the best-validation snapshot separately (validation is
                # noisy under sigma noise, so the final epoch can regress)
                if val_loss <= min(self.history["val_loss"] + [self.best_val]):
                    self.best_val = val_loss
                    checkpoints.save_run(os.path.join(self.log_dir, "best"),
                                         self.eval_params, args, self.parser)
        return self.models

    def _validate(self, val_arrays, n_val: int, epoch: int = 0, full: bool = False) -> float:
        """Masked validation loss over the FULL val set (or a strided subset).

        Every ray is visited exactly once: the tail batch is padded to the
        batch shape with its last ray and the pads are masked out of the mean.
        --val_rays > 0 caps the per-epoch cost with a stride over the whole
        set whose OFFSET is reseeded per epoch; the last epoch (`full=True`)
        always validates the full set.
        """
        val_rays = int(getattr(self.args, "val_rays", 0) or 0)
        if not full and 0 < val_rays < n_val:
            stride = n_val / val_rays
            offset = np.random.RandomState(
                int(getattr(self.args, "seed", 0) or 0) * 1000003 + epoch).uniform(0.0, stride)
            all_idx = np.minimum(np.arange(val_rays) * stride + offset,
                                 n_val - 1).astype(np.int64)
        else:
            all_idx = np.arange(n_val, dtype=np.int64)
        bs = int(self.args.batchsize_val)
        total, weight = 0.0, 0.0
        with self._eval_weights():
            for lo in range(0, len(all_idx), bs):
                idx = all_idx[lo:lo + bs]
                n_real = len(idx)
                if n_real < bs:
                    idx = np.concatenate([idx, np.full(bs - n_real, idx[-1])])
                mask = torch.zeros(bs, dtype=torch.float32, device=self.device)
                mask[:n_real] = 1.0
                aux = self.eval_step(self.gather(val_arrays, idx), mask)
                total += float(aux["loss"]) * n_real
                weight += n_real
        return total / weight if weight else float("nan")
