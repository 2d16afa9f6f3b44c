"""Training traffic: the program's own epoch loop, one caller, closed loop.

Set-up makes `train_views` + `val_views` views of `resolution`^2 rays with
their ray-traced targets (scene.py), builds the nets with the program's
factory and loads the harness's weights into them, builds the pipeline and a
`Solver` as the training entry point does (no run directory, so no
checkpoint writes), and calls `Solver.train`. That one call is the traffic:
it draws each batch, gathers it, steps, reads the loss back and validates
every epoch. The first `warmup_epochs` epochs are set-up (every shape of the
loop runs there); the window opens at that epoch's end and closes at the
first epoch end after `--seconds` (after `trace_epochs` epochs when traced,
then one more labelled epoch for the breakdown; trace.py), stopped through
the loop's own per-epoch callback.

The loop's first three steps are recorded as they happen (the rows each
gathered, its loss, Adam's first moment after step 1, the weights after step
3) and held against reference.train_steps on the same rows from the same
weights and draws, once the window has closed and the program is freed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import checks, reference, scene
from port_bench.harness import Outcome, free_program, launch_counts
from port_bench.trace import Tracer, breakdown

CHECKED_STEPS = 3
FAULT_OFFSET = 1.0 / 32.0


class WindowClosed(Exception):
    """Raised from the loop's callback (or after the checked steps) to stop it."""


class FirstSteps:
    """Records the first CHECKED_STEPS train steps of the solver's loop."""

    def __init__(self, solver, stop_after: bool):
        self.solver = solver
        self.stop_after = stop_after
        self.idx, self.losses = [], []
        self.grad1 = self.params = None
        self._pending = None
        gather, step = solver.gather, solver.train_step

        def recording_gather(arrays, idx):
            self._pending = np.asarray(idx).copy()
            return gather(arrays, idx)

        def recording_step(batch, *a, **k):
            aux = step(batch, *a, **k)
            if len(self.losses) < CHECKED_STEPS:
                self.idx.append(self._pending)
                self.losses.append(aux["loss"].detach().clone())
                if len(self.losses) == 1:
                    self.grad1 = self._first_moment()
                if len(self.losses) == CHECKED_STEPS:
                    self.params = {m: {k: v.detach().clone() for k, v in mod.named_parameters()}
                                   for m, mod in solver.models.items()}
                    if self.stop_after:
                        raise WindowClosed
            return aux

        solver.gather, solver.train_step = recording_gather, recording_step

    def _first_moment(self):
        """Adam's first moment over 1 - beta1 (zero for a leaf it never stepped)."""
        opt = self.solver.optimizer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]

        def grad(p):
            state = opt.state.get(p, {})
            if "exp_avg" not in state:
                return torch.zeros_like(p)
            return state["exp_avg"].detach().clone() / (1.0 - beta1)

        return {m: {k: grad(p) for k, p in mod.named_parameters()}
                for m, mod in self.solver.models.items()}

    def program(self) -> dict:
        return {"losses": [float(x) for x in self.losses], "grad1": self.grad1,
                "params": self.params}


class EpochWindow:
    """The loop's per-epoch callback: opens the window after the warm-up
    epochs and closes it at the first epoch end past the window's length.
    Traced, the window is `traced` epochs recorded on the device alone, and
    one more epoch records the host's labels for the breakdown."""

    def __init__(self, run, tracer: Tracer, warmup: int, traced: int):
        self.run, self.tracer = run, tracer
        self.warmup, self.traced = warmup, traced
        self.t_start = self.t_end = None
        self.steps0 = self.steps = self.losses0 = 0
        self.losses = []
        self.epochs = 0
        self.launches0 = self.launches = {}
        self.summary = self.labelled = None
        self.epoch_ends = []

    def __call__(self, solver, epoch: int) -> None:
        self.run.sync()
        now = time.perf_counter()
        self.epoch_ends.append(now)
        if epoch + 1 == self.warmup:
            self.t_start, self.steps0 = now, solver.global_step
            self.losses0 = len(solver.history["step_loss"])
            self.launches0 = launch_counts()
            if self.run.trace:
                self.tracer.start(labelled=False)
            return
        if self.t_start is None:
            return
        if self.t_end is not None:             # the labelled epoch after a traced window
            self.labelled = self.tracer.stop()
            raise WindowClosed
        self.epochs += 1
        if self.run.trace and self.epochs < self.traced:
            return
        if not self.run.trace and now - self.t_start < self.run.seconds:
            return
        self.t_end, self.steps = now, solver.global_step - self.steps0
        self.losses = solver.history["step_loss"][self.losses0:]
        self.launches = {k: v - self.launches0.get(k, 0) for k, v in launch_counts().items()}
        if not self.run.trace:
            raise WindowClosed
        self.summary = self.tracer.stop()
        self.tracer.start(labelled=True)


def _ray_data(views: dict, sl: slice, res: int, fov: float):
    from smpl_nerf_tpu_torch.data.datasets import RayData

    origins = views["origins"][sl]
    n = origins.shape[0]

    def host(t):
        return t.reshape(-1, t.shape[-1]).cpu().numpy()

    return RayData(origins=host(origins), directions=host(views["directions"][sl]),
                   image_indices=np.repeat(np.arange(n, dtype=np.int32), res * res),
                   h=res, w=res, focal=scene.focal(res, fov), num_images=n,
                   camera_transforms=views["cams"][sl].cpu().numpy(),
                   human_poses=views["poses"][sl].cpu().numpy(),
                   rgb=host(views["rgb"][sl]))


class _ZeroGrad(torch.autograd.Function):
    """The identity, whose backward hands back a zero gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _plant(fault, solver, pipeline) -> None:
    """A planted fault (tests and calibrate.py only)."""
    if fault == "warp_unstepped":
        # the warp field's leaves left out of the optimizer's groups
        warp = {id(p) for name, model in solver.models.items() if "warp" in name
                for p in model.parameters()}
        if not warp:
            raise ValueError("warp_unstepped: the configuration has no warp field")
        for group in solver.optimizer.optimizer.param_groups:
            group["params"] = [p for p in group["params"] if id(p) not in warp]
    elif fault == "dx_zeroed":
        # the nets hand no gradient back to their input rows (positions,
        # directions, prefix), as kernel C would with its dX zeroed
        net = pipeline.passes.run

        def no_dx(key, samples, dirs_unit, prefix=None):
            return net(key, _ZeroGrad.apply(samples), _ZeroGrad.apply(dirs_unit),
                       None if prefix is None else _ZeroGrad.apply(prefix))

        pipeline.passes.run = no_dx
    elif fault == "unchanged":
        solver.optimizer.step = lambda: None
    elif fault == "half_batch":
        step = solver.train_step

        def half(batch, *a, **k):
            n = batch["ray_translation"].shape[0]
            return step({key: v[:n // 2] if v.shape[:1] == (n,) else v
                         for key, v in batch.items()}, *a, **k)

        solver.train_step = half
    elif fault == "altered":
        fine = pipeline.passes.fine

        def altered(*a, **k):
            out, extras = fine(*a, **k)
            return out._replace(rgb=out.rgb + FAULT_OFFSET), extras

        pipeline.passes.fine = altered
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def run(r) -> Outcome:
    from smpl_nerf_tpu_torch.ops import _build
    from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
    from smpl_nerf_tpu_torch.training import factory
    from smpl_nerf_tpu_torch.training.solver import Solver

    p, flags, dev = r.params, r.flags, r.device
    if dev.type == "cuda":
        _build.build_all()
    args = r.program_args()
    res, n_train, n_val = int(p["resolution"]), int(p["train_views"]), int(p["val_views"])
    views = scene.make_views(r.seed, 11, n_train + n_val, 360.0 / (n_train + n_val), p,
                             flags["human_joints"], bool(flags["white_background"]), dev,
                             with_rgb=True)
    train_data = _ray_data(views, slice(0, n_train), res, float(p["fov_deg"]))
    val_data = _ray_data(views, slice(n_train, None), res, float(p["fov_deg"]))
    extras = factory.dataset_extras(args, train_data)
    models, encoders = factory.build_models_and_params(args, seed=args.seed, device=dev,
                                                       extras=extras)
    weights = scene.make_weights(flags, r.seed, views, dev,
                                 bool(r.workload.cell["centre_density"]))
    for name, model in models.items():
        model.load_state_dict(weights[name])
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
    solver = Solver(pipeline, args, log_dir=None)
    tracer = Tracer(r.trace, dev, outside="Solver.train loop")
    for attr in ("gather", "train_step", "_validate"):
        tracer.label(solver, attr, f"Solver.{attr}")
    tracer.label(solver.optimizer, "step", "optimizer.step")
    tracer.label(solver, "loss_fn", "loss_fn (forward)")
    tracer.label(pipeline.passes, "coarse", "passes.coarse")
    tracer.label(pipeline.passes, "fine", "passes.fine")
    _plant(r.fault, solver, pipeline)
    first = FirstSteps(solver, stop_after=r.steps_only)
    window = EpochWindow(r, tracer, int(p["warmup_epochs"]), int(p["trace_epochs"]))
    try:
        solver.train(train_data, val_data, callback=window)
    except WindowClosed:
        pass
    r.sync()
    launches = window.launches
    failed = int(sum(not np.isfinite(x) for x in window.losses))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    bs = int(args.batchsize)
    steps_per_epoch = max(1, train_data.num_rays // bs)
    val_batches = -(-val_data.num_rays // int(args.batchsize_val))
    ours = first.program()
    val_losses = [float(v) for v in solver.history["val_loss"]]
    first.solver = None
    del solver, pipeline, models, encoders
    free_program()

    rows = torch.arange(n_train * res * res, device=dev)
    image = rows // (res * res)
    flat = {k: views[k][:n_train].reshape(-1, views[k].shape[-1])
            for k in ("origins", "directions", "rgb")}
    batches = []
    for idx in first.idx:
        i = torch.as_tensor(idx, device=dev)
        batches.append({"origins": flat["origins"][i], "directions": flat["directions"][i],
                        "rgb": flat["rgb"][i], "poses": views["poses"][image[i]]})
    seed = scene.program_seed(r.seed)
    ref = reference.train_steps(flags, weights, batches, seed,
                               reference.stated_precision(flags))
    readings = checks.train_readings(ours, ref, weights)
    details = checks.train_details(ours, ref, weights) if r.steps_only else None
    control = None
    if r.control:
        fp8 = reference.train_steps(flags, weights, batches, seed, "fp8")
        control = checks.train_readings(fp8, ref, weights)

    outcome = Outcome(attempted=window.steps, failed=failed, end_to_end={}, readings=readings,
                      memory_peak_bytes=peak, launches=launches, control_readings=control)
    if window.t_end is None:          # stopped after the checked steps
        outcome.notes = {"details": details}
        return outcome
    window_s = window.t_end - window.t_start
    outcome.window_s = window_s
    outcome.end_to_end = {"train_rays_per_s": window.steps * bs / window_s,
                          "setup_s": window.t_start - r.t0}
    outcome.notes = {"window": f"{window.steps} steps ({window.epochs} epochs of "
                               f"{steps_per_epoch}) in {window_s!r} s",
                     "losses of the checked steps": ours["losses"],
                     "val loss by epoch": val_losses,
                     "epoch seconds": [b - a for a, b in zip(window.epoch_ends,
                                                             window.epoch_ends[1:])]}
    if r.trace and dev.type == "cuda":
        outcome.summary = window.summary
        outcome.breakdown = breakdown(window.summary, window.labelled)
        outcome.record = {"kind": "train", "flags": flags, "summary": window.summary,
                          "window_s": window_s, "steps": window.steps, "batch": bs,
                          "eval_rays": window.epochs * val_data.num_rays,
                          "eval_batches": window.epochs * val_batches,
                          "eval_padded_rays": window.epochs * val_batches
                          * int(args.batchsize_val),
                          "launches": launches}
    return outcome
