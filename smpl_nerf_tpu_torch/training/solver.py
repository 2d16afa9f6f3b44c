"""Training solver (counterpart of smpl_nerf_tpu/training/solver.py).

One train step (loss, backward, Adam with parameter groups, optional EMA) and
a thin epoch loop: seeded ray permutation, wrap-around batches, optional
foreground oversampling, masked validation over the whole val split, a
per-epoch run-dir save with `val_curve.json`, the resume state and the
best-validation snapshot.

  * loss = MSE(rgb_coarse) + MSE(rgb_fine) [+ the GMM density prior of
    --use_gmm_loss: MSE(gmm.pdf(ray_samples), densities), the mixture's
    means at the canonical SMPL vertices],
  * Adam / AdamW with the reference's groups: `net` on --lrate, `pose`
    (estimator parameters) on --lrate_pose, `frozen`; a group whose learning
    rate is 0 is left out of the optimizer, so it does not move at all,
  * --lrate_decay k: lr * 0.1^(step / (k * 1000)), the step counted from 0.

The dataset arrays go to the device once; a batch is an index gather. Where
the JAX package compiles a step (and, with --scan_steps, several) into one
program, this steps eagerly, one batch at a time. --images_per_batch K draws
each batch from K images (the same numpy draws as the JAX solver, so the same
indices for the same seed); the SMPL-driven families then run LBS on those K
poses only, and validation and renders must keep every batch within K images
(`check_batch_images`). Validation and renders of those families look poses up
in the table of the split they evaluate (`swap_pose_table`); in-step
vertex_sphere batches carry their goal-mesh table whole ('_itable') and are
guarded the same way. `warp` trains its warp field alone on MSE against the
dataset's warp; Adam leaves the nets, which get no gradient, where they are.

--check_nans: an epoch whose mean train loss is not finite raises
RuntimeError with the NaN / Inf count of every non-finite parameter
(`nan_report`), or says that the parameters are still finite. With a
`writer` (an object with add_scalar / add_image / add_mesh), every epoch logs
loss/train, loss/val and perf/rays_per_sec, and re-renders the first
--number_validation_images val images whole: the GT-vs-rerender grid (with
the warp magnitude for the warp families), the warp point cloud at the
--mesh_epochs fractions, and the first image's first batch of density
samples as vedo_data (training/logging.py).

Spans (`tracing`, recorded only while the recorder is on): `solver.epoch`
holds an epoch; each step's `solver.draw`, `solver.gather`, `solver.step`
(`solver.forward`, `solver.backward` with the all-reduce, `solver.optimizer`
with the EMA) and `solver.loss_read` carry the global step as their request;
`solver.validate` and the run-dir saves' `solver.save` carry the epoch (an
early validation the global step, as its `_validate` call does).

Parallel training (parallel/): the solver runs on a ('data', 'model') mesh
(--mesh_shape; one process per device, parallel/mesh.py). Without a process
group it is the single-device code above. With one, every rank draws the
same global batch indices from the same numpy stream (the batch padded to a
multiple of the data axis, as JAX pads it), takes its own rows
(multihost.local_row_range), and draws jitter and sigma noise for the whole
global batch before keeping its rows (integrate.RowDraws), so the world size
does not change the numbers. Each rank's loss is its share of the global mean
(its rows over the global rows); the gradients are summed over the data
group, and so are the losses that are reported. Validation all-reduces the
masked sum and the mask count, never local means; per-epoch rerenders
all-gather the ranks' rows. Every rank starts from rank 0's weights.
--tensor_parallel=1 with a model axis > 1 splits the trunk layers over the
model group (parallel/tp.py); Adam and the EMA run on the shards, and the run
dir and the resume state hold whole tensors (gathered on save, cut on
restore). A resume learns from rank 0 whether train_state.pt exists, and its
bytes (checkpoints.broadcast_file), so every rank takes the same branch.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.core.gmm import GaussianMixture
from smpl_nerf_tpu_torch.core.integrate import RowDraws
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod
from smpl_nerf_tpu_torch.parallel import multihost, tp
from smpl_nerf_tpu_torch.pipelines import DYNAMIC_FAMILIES, Pipeline, get_pose_table
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training import logging as log_mod


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


def nan_report(models: Dict[str, torch.nn.Module], name: str = "params") -> str:
    """Per-parameter NaN / Inf counts, a line for each parameter that has
    any (`{name}{model}/{parameter}: n NaN, m Inf of size`); empty when every
    parameter is finite."""
    lines = []
    for model_name, model in models.items():
        for key, p in model.named_parameters():
            if not p.is_floating_point():
                continue
            n_nan = int(torch.isnan(p).sum())
            n_inf = int(torch.isinf(p).sum())
            if n_nan or n_inf:
                lines.append(f"  {name}{model_name}/{key}: {n_nan} NaN, {n_inf} Inf "
                             f"of {p.numel()}")
    return "\n".join(lines)


def gather_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor) -> dict:
    """Gather a ray batch from device-resident dataset arrays.

    Keys ending in '_table' are per-IMAGE arrays (e.g. 'human_pose_table'
    [N_img, 69]); they are mapped through the gathered image_indices, so the
    pipeline sees a per-ray key ('human_pose' [R, 69]) without the dataset
    ever holding per-ray duplicates. Keys ending in '_itable' pass through
    whole: the pipeline reads the rows of the batch's images itself (in-step
    vertex_sphere's goal meshes, [N_img, V, 3]).
    """
    batch = {k: v[idx] for k, v in arrays.items()
             if not (k.endswith("_table") or k.endswith("_itable"))}
    for k, v in arrays.items():
        if k.endswith("_itable"):
            batch[k] = v
        elif k.endswith("_table"):
            batch[k[:-len("_table")]] = v[batch["image_indices"].long()]
    return batch


@contextlib.contextmanager
def swap_pose_table(models, goal_poses):
    """Inside the block the dummy estimator looks poses up in `goal_poses`.

    The table holds the poses of the split the run was trained on, while
    image_indices are local to each split: evaluating another split
    (validation, inference scoring) must use that split's own poses. A no-op
    without a table (image-wise estimator, other families) or without
    goal_poses.
    """
    old = get_pose_table(models)
    if goal_poses is None or old is None:
        yield
        return
    est = models["smpl_estimator"]
    est.goal_poses = torch.as_tensor(np.asarray(goal_poses, np.float32), device=old.device)
    try:
        yield
    finally:
        est.goal_poses = old


def check_batch_images(cfg, idx: np.ndarray, image_indices: np.ndarray,
                       arrays=None) -> None:
    """Refuse an evaluation or render batch that spans more than
    --images_per_batch images: the in-step lookup keeps K of them and would
    give the other rays the wrong image's mesh without a word. Guards the
    SMPL-driven families, and in-step vertex_sphere (`arrays` holding
    'goal_verts_itable')."""
    K = int(cfg.images_per_batch or 0)
    dedups = (cfg.model_type in DYNAMIC_FAMILIES
              or (arrays is not None and "goal_verts_itable" in arrays))
    if not K or not dedups:
        return
    if K >= int(image_indices.max()) + 1:
        return
    distinct = len(np.unique(image_indices[idx]))
    if distinct > K:
        raise ValueError(f"images_per_batch={K}: an evaluation batch spans {distinct} "
                         "distinct images; lower batchsize_val / adjust val_rays or raise "
                         "images_per_batch")


def make_loss_fn(pipeline: Pipeline, canonical_vertices=None) -> Callable:
    """Loss = MSE(coarse) + MSE(fine) [+ GMM density prior, with
    --use_gmm_loss and canonical vertices]; for `warp`, MSE(warp) alone."""
    gmm = None
    if pipeline.cfg.use_gmm_loss and canonical_vertices is not None:
        gmm = GaussianMixture(canonical_vertices, pipeline.cfg.gmm_std)

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
        if pipeline.cfg.model_type == "warp":
            # the supervised warp field: MSE against the dataset's warp
            loss = _mean((out["warp"] - batch["warp"]) ** 2)
            return loss, {"loss": loss, "loss_coarse": loss, "loss_fine": loss}
        rgb_truth = batch["rgb"]
        loss_c = _mean((out["rgb_coarse"] - rgb_truth) ** 2)
        loss_f = _mean((out["rgb_fine"] - rgb_truth) ** 2)
        loss = loss_c + loss_f
        aux = {"loss_coarse": loss_c, "loss_fine": loss_f}
        if gmm is not None and "ray_samples" in out:
            gmm_loss = _mean((gmm.pdf(out["ray_samples"]) - out["densities"]) ** 2)
            loss = loss + gmm_loss
            aux["loss_gmm"] = gmm_loss
        aux["loss"] = loss
        return loss, aux

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
                 parser=None, frozen_nerf: bool = False, canonical_vertices=None,
                 writer=None, mesh: Optional[mesh_mod.Mesh] = None):
        self.pipeline = pipeline
        self.models = pipeline.models
        self.args = args
        self.parser = parser
        self.log_dir = log_dir
        self.writer = writer
        self.device = next(self.models["model_coarse"].parameters()).device
        self.mesh = mesh if mesh is not None else mesh_mod.make_mesh(
            getattr(args, "mesh_shape", "") or "", self.device)
        self.n_data = self.mesh.data
        self.tensor_parallel = (int(getattr(args, "tensor_parallel", 0) or 0) > 0
                                and self.mesh.model > 1)
        for model in self.models.values():
            model.requires_grad_(True)
        # every rank trains from rank 0's weights, split over the model group
        # under tensor parallelism (before the optimizer takes the parameters)
        multihost.put_replicated({name: m.state_dict() for name, m in self.models.items()},
                                 self.mesh)
        self.tp_dims = tp.place_params_tp(self.models, self.mesh) if self.tensor_parallel else {}
        # the rerenders are collective: every rank runs them when rank 0 logs
        self.rerenders = bool(multihost.from_rank0(writer is not None, self.mesh))
        self.loss_fn = make_loss_fn(pipeline, canonical_vertices)
        self.optimizer = make_optimizer(self.models, args, args.model_type, frozen_nerf)
        self.global_step = 0
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        # resume accounting (restore_train_state): epoch numbering continues
        # and the best-val snapshot of before the resume is never overwritten
        # by a worse later epoch
        self.epoch_offset = 0
        self.best_val = float("inf")
        self.val_curve = []  # per-epoch metrics, persisted as val_curve.json

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

    def run_state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """What a run directory saves: `eval_params` with each module's
        buffers (the dummy estimator's pose table)."""
        if self.ema_params is None:
            return self.raw_state_dicts()
        return {name: {**dict(m.named_buffers()), **self.ema_params[name]}
                for name, m in self.models.items()}

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
    def train_step(self, batch, generator=None, share: Optional[float] = None) -> dict:
        """grad -> optimizer update (-> EMA); returns the loss terms.

        share: this rank's rows over the global batch's, on a mesh with a
        process group: the loss is scaled by it, and the gradients and the
        returned losses are summed over the data group (the global means)."""
        self.optimizer.zero_grad()
        with tracing.span("solver.forward"):
            loss, aux = self.loss_fn(batch, generator, True)
        with tracing.span("solver.backward"):
            if share is None:
                loss.backward()
            else:
                (loss * share).backward()
                grads = [p.grad for m in self.models.values() for p in m.parameters()
                         if p.grad is not None]
                multihost.all_reduce_flat(grads, self.mesh.data_group)
                terms = list(aux)
                sums = torch.stack([aux[k].detach().float() * share for k in terms])
                multihost.all_reduce_flat([sums], self.mesh.data_group)
                aux = dict(zip(terms, sums.unbind(0)))
        with tracing.span("solver.optimizer"):
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

    def local_rows(self, n: int) -> tuple:
        """[lo, hi) of an n-row global batch that this rank computes."""
        return multihost.local_row_range(self.mesh, n) if self.mesh.distributed else (0, n)

    def draws(self, n: int):
        """The jitter / noise generator of an n-row global batch: on a mesh
        with a group, the global rows' draws of which this rank keeps its own."""
        if not self.mesh.distributed or self.generator is None:
            return self.generator
        return RowDraws(self.generator, *self.local_rows(n), n)

    # -------------------------------------------------------------- resume
    def save_run(self, run_dir: str, dataset_dir: Optional[str] = None) -> None:
        """The run dir of `run_state_dicts` (whole tensors; call on every rank)."""
        checkpoints.save_run(run_dir, self.run_state_dicts(), self.args, self.parser,
                             dataset_dir, mesh=self.mesh, dims=self.tp_dims)

    def _train_state_dims(self) -> dict:
        """Which leaves of the resume state are tensor-parallel shards (dim 0)."""
        if not self.tp_dims:
            return {}
        dims = {id(p): self.tp_dims[name].get(key) for name, m in self.models.items()
                for key, p in m.named_parameters()}
        state = {}
        if self.optimizer.optimizer is not None:
            order = [p for g in self.optimizer.optimizer.param_groups for p in g["params"]]
            state = {i: {"exp_avg": d, "exp_avg_sq": d, "max_exp_avg_sq": d}
                     for i, p in enumerate(order) if (d := dims.get(id(p))) is not None}
        return {"optimizer": {"optimizer": {"state": state}}, "ema": self.tp_dims,
                "raw": self.tp_dims}

    def save_train_state(self, run_dir: str, epoch: int, best_val: float) -> None:
        checkpoints.save_train_state(
            run_dir, self.optimizer.state_dict(), self.ema_params, epoch,
            raw_params=self.raw_state_dicts() if self.ema_params is not None else None,
            best_val=best_val, mesh=self.mesh, dims=self._train_state_dims())

    def restore_train_state(self, run_dir: str) -> bool:
        """Restore optimizer moments (+ EMA shadow + raw weights + epoch and
        best-val accounting) saved by save_train_state; False when the run
        directory has none (weights-only resume). Across processes every rank
        learns existence and bytes from rank 0 (`broadcast_file`) before any
        other collective, so all take the same branch."""
        data = None
        if mesh_mod.is_distributed():
            data = checkpoints.broadcast_file(os.path.join(run_dir, checkpoints.TRAIN_STATE))
            if data is None:
                return False
        state = checkpoints.load_train_state(run_dir, self.device, data=data)
        if state is None:
            return False
        state = tp.shard_tree(state, self.mesh, self._train_state_dims())
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
        # validation of the SMPL-driven families looks poses up in the VAL
        # split's table (image_indices are split-local)
        self._val_goal_poses = getattr(val_data, "human_poses", None)
        n = train_data.num_rays
        bs = mesh_mod.pad_to_multiple(int(args.batchsize), self.n_data)
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

        # --images_per_batch: draw each batch from at most K images, so the
        # in-step LBS runs on K poses; rays are stored contiguously per image
        ipb = int(getattr(args, "images_per_batch", 0) or 0)
        n_img = train_data.num_images
        hw = n // max(1, n_img)
        ipb = ipb if 0 < ipb < n_img else 0
        bs_val = mesh_mod.pad_to_multiple(int(args.batchsize_val), self.n_data)
        if ipb and model_type in DYNAMIC_FAMILIES and bs_val > max(1, ipb - 1) * hw:
            # sequential validation batches must fit inside K images too
            # (check_batch_images catches the strided cases per batch)
            raise ValueError(
                f"images_per_batch={ipb}: batchsize_val={bs_val} can span more than "
                f"{ipb} images ({hw} rays/image); lower batchsize_val or raise "
                "images_per_batch")
        fg_mask = None
        if ipb and fg_ratio > 0.0:
            fg_mask = np.zeros(n, bool)
            fg_mask[fg_idx] = True

        def draw_batch_indices():
            # the JAX solver's numpy draws, in its order
            if ipb:
                imgs = np_rng.choice(n_img, ipb, replace=False)
                cand = (imgs[:, None] * hw + np.arange(hw)[None, :]).reshape(-1)
                if fg_ratio > 0.0:
                    cfg_, cbg = cand[fg_mask[cand]], cand[~fg_mask[cand]]
                    if len(cfg_) and len(cbg):
                        n_fg = int(bs * fg_ratio)
                        return np.concatenate([cfg_[np_rng.randint(0, len(cfg_), n_fg)],
                                               cbg[np_rng.randint(0, len(cbg), bs - n_fg)]])
                return cand[np_rng.randint(0, len(cand), bs)]
            n_fg = int(bs * fg_ratio)
            fg = fg_idx[np_rng.randint(0, len(fg_idx), n_fg)]
            bg = bg_idx[np_rng.randint(0, len(bg_idx), bs - n_fg)]
            return np.concatenate([fg, bg])

        for epoch in range(int(args.num_epochs)):
            with tracing.span("solver.epoch", request=self.epoch_offset + epoch):
                perm = np_rng.permutation(n)
                epoch_losses = []
                t0 = time.time()
                for step in range(steps_per_epoch):
                    request = self.global_step
                    with tracing.span("solver.draw", request):
                        if fg_ratio > 0.0 or ipb:
                            idx = draw_batch_indices()
                        else:
                            lo = (step * bs) % max(1, n - bs + 1) if n >= bs else 0
                            idx = perm[lo:lo + bs]
                            if len(idx) < bs:  # wrap around for tiny datasets
                                idx = np.concatenate([idx, perm[:bs - len(idx)]])
                    lo, hi = self.local_rows(bs)
                    share = {"share": (hi - lo) / bs} if self.mesh.distributed else {}
                    with tracing.span("solver.gather", request):
                        batch = self.gather(arrays, idx[lo:hi])
                    with tracing.span("solver.step", request):
                        aux = self.train_step(batch, self.draws(bs), **share)
                    with tracing.span("solver.loss_read", request):
                        epoch_losses.append(float(aux["loss"]))   # synchronises the device
                    self.global_step += 1
                    if early_val and step % int(args.log_iterations) == 0:
                        with tracing.span("solver.validate", self.global_step):
                            val_early = self._validate(val_arrays, val_data.num_rays,
                                                       epoch=self.global_step)
                        self.history.setdefault("val_loss_early", []).append(val_early)
                self.history.setdefault("step_loss", []).extend(epoch_losses)
                train_loss = float(np.mean(epoch_losses))
                if int(getattr(args, "check_nans", 0)) and not np.isfinite(train_loss):
                    report = nan_report(self.models)
                    raise RuntimeError(
                        f"non-finite train loss {train_loss} at epoch {epoch}"
                        + (f"; non-finite params:\n{report}" if report else
                           " (params still finite - NaN originated in the loss)"))
                with tracing.span("solver.validate"):
                    val_loss = self._validate(val_arrays, val_data.num_rays,
                                              epoch=self.epoch_offset + epoch,
                                              full=epoch == int(args.num_epochs) - 1)
                dt = time.time() - t0
                rays_per_sec = steps_per_epoch * bs / dt
                self.history["train_loss"].append(train_loss)
                self.history["val_loss"].append(val_loss)
                self._log("loss/train", train_loss)
                self._log("loss/val", val_loss)
                self._log("perf/rays_per_sec", rays_per_sec)
                print(f"[epoch {self.epoch_offset + epoch}] train {train_loss:.5f} "
                      f"val {val_loss:.5f} psnr {mse2psnr(max(val_loss / 2, 1e-10)):.2f} "
                      f"({rays_per_sec:,.0f} rays/s)")
                if self.rerenders:
                    self._log_rerenders(val_arrays, val_data, epoch)
                if callback is not None:
                    callback(self, epoch)
                if self.log_dir:
                    with tracing.span("solver.save"):
                        # every rank: the saves gather tensor-parallel shards; rank 0 writes
                        self.save_run(self.log_dir)
                        # machine-readable per-epoch curve (absolute epoch numbering
                        # survives --load_run resumes)
                        self.val_curve.append({
                            "epoch": self.epoch_offset + epoch,
                            "train_loss": float(train_loss), "val_loss": float(val_loss),
                            "psnr_estimate": float(mse2psnr(max(val_loss / 2, 1e-10))),
                            "rays_per_sec": round(rays_per_sec, 1)})
                        if self.mesh.rank == 0:
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
                            self.save_run(os.path.join(self.log_dir, "best"))
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
        bs = mesh_mod.pad_to_multiple(int(self.args.batchsize_val), self.n_data)
        img_idx = (val_arrays["image_indices"].cpu().numpy()
                   if self.pipeline.cfg.images_per_batch else None)
        r_lo, r_hi = self.local_rows(bs)
        total, weight = 0.0, 0.0
        with self._eval_weights(), swap_pose_table(self.models,
                                                   getattr(self, "_val_goal_poses", None)):
            for lo in range(0, len(all_idx), bs):
                idx = all_idx[lo:lo + bs]
                n_real = len(idx)
                if n_real < bs:
                    idx = np.concatenate([idx, np.full(bs - n_real, idx[-1])])
                if img_idx is not None:
                    check_batch_images(self.pipeline.cfg, idx, img_idx, val_arrays)
                mask = torch.zeros(bs, dtype=torch.float32, device=self.device)
                mask[:n_real] = 1.0
                mask = mask[r_lo:r_hi]
                aux = self.eval_step(self.gather(val_arrays, idx[r_lo:r_hi]), mask)
                loss = aux["loss"]
                if self.mesh.distributed:
                    # the global masked mean: sum and count over the data
                    # group (a rank whose rows are all pads adds 0 and 0)
                    count = mask.sum()
                    sums = torch.stack([loss.float() * count, count])
                    multihost.all_reduce_flat([sums], self.mesh.data_group)
                    loss = sums[0] / sums[1]
                total += float(loss) * n_real
                weight += n_real
        return total / weight if weight else float("nan")

    def _log(self, tag: str, value: float) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, self.global_step)

    @torch.no_grad()
    def _log_rerenders(self, val_arrays, val_data, epoch: int) -> None:
        """The first --number_validation_images val images rendered whole
        (batches of at most 4096 rays, the last padded with its last ray):
        the rerender grid, the warp cloud of image 0 at the --mesh_epochs
        fractions, and the first batch's density samples of image 0 as
        vedo_data, as the JAX solver logs them."""
        n_img = min(int(self.args.number_validation_images), val_data.num_images)
        if n_img <= 0:
            return
        hw = val_data.h * val_data.w
        bs = mesh_mod.pad_to_multiple(min(hw, 4096), self.n_data)
        r_lo, r_hi = self.local_rows(bs)
        rank0 = self.mesh.rank == 0
        mesh_epochs = {int(float(f) * int(self.args.num_epochs))
                       for f in getattr(self.args, "mesh_epochs", []) or []}
        warp_cloud = epoch in mesh_epochs
        renders, gts, warps, densities, samples = [], [], [], [], []
        with self._eval_weights(), swap_pose_table(self.models,
                                                   getattr(val_data, "human_poses", None)):
            for i in range(n_img):
                rgb_img, warp_img = [], []
                for lo in range(i * hw, (i + 1) * hw, bs):
                    idx = np.arange(lo, min(lo + bs, (i + 1) * hw))
                    take = len(idx)
                    if take < bs:
                        idx = np.concatenate([idx, np.full(bs - take, idx[-1])])
                    out = self.pipeline(self.gather(val_arrays, idx[r_lo:r_hi]), None, False)
                    out = {k: multihost.all_gather_rows(out[k], self.mesh)[:take]
                           .float().cpu().numpy()
                           for k in ("rgb_fine", "densities", "ray_samples", "warp") if k in out}
                    rgb_img.append(out["rgb_fine"])
                    if "warp" in out:
                        warp_img.append(np.linalg.norm(out["warp"], axis=-1).max(-1))
                    if lo == i * hw and "densities" in out and "ray_samples" in out:
                        densities.append(out["densities"])
                        samples.append(out["ray_samples"])
                        if warp_cloud and "warp" in out and i == 0 and rank0:
                            log_mod.tensorboard_warps(self.writer, self.global_step,
                                                      out["ray_samples"], out["warp"])
                renders.append(np.concatenate(rgb_img).reshape(val_data.h, val_data.w, 3))
                gts.append(val_data.rgb[i * hw:(i + 1) * hw].reshape(val_data.h, val_data.w, 3))
                if warp_img:
                    warps.append(np.concatenate(warp_img).reshape(val_data.h, val_data.w))
        if not rank0:
            return
        log_mod.tensorboard_rerenders(self.writer, n_img, np.stack(renders), np.stack(gts),
                                      self.global_step, np.stack(warps) if warps else None)
        if self.log_dir and densities:
            log_mod.vedo_data(self.log_dir, densities[0], samples[0], epoch=epoch)
