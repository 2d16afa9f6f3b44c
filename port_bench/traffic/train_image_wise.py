"""Training traffic of the image_wise_dynamic family: the program's own
pose-optimisation loop (`training/image_wise.train_image_wise`), one caller,
closed loop.

Set-up writes the run's seeded body in SMPL's pkl format (port_bench/body.py)
and the seeded frozen coarse net (scene.lecun_weights, a state dict under
build/port_bench_cache/image_wise/), hands both to the program through
--smpl_model_path and --load_coarse_model, makes the views (every one at the
traffic's arm angle), seeds numpy's global generator as the training entry
point does, and calls `train_image_wise`. That call is the traffic: per image
in a seeded order, its upload and depths, then steps of `batchsize` of its
rays (LBS, the attention, the net, the backward into the two arm angles,
Adam), each ending in the loss read. Through the loop's per-step callback the
first `warmup_steps` steps (one image) are set-up; the window opens at that
step's end and closes at the first step end past `--seconds` (traced: after
`trace_steps` steps on the device alone, then `labelled_steps` more with the
host's operations, for the breakdown; trace.py).

The first three steps are recorded at the seams `image_wise.make_pose_loss`
(each step's rays, depths and targets) and `image_wise.relu_attention_warp`
(each step's warps), and by the callback (loss, the two angles' gradients, the
angles after the step). Once the program is freed, reference_image_wise
repeats them from the same net, rays and depths: `loss1_gap`,
`pose_grad_gap`, `warp_gap` (reference_image_wise.readings); `angles_gap`
holds the angles after step 3 against the reference's Adam on the program's
own three gradients.
The first step starts from the zero pose, where every warp is 0 and so is the
attention's gradient into its goal vertices. That gradient is held at the
last warm-up step, where the arms have moved (canonical != goal): the
attention's seam records that step's inputs (samples, goal vertices, warps,
radius); once the run is over, the program's attention takes them again and
gives its gradient into the goal vertices under a seeded cotangent
(reference_image_wise.cotangent: normal, 0 on the samples whose gradient
float32 cannot settle), and reference_image_wise.attention_vjp gives it in
float64: `goal_vjp_gap`.

Traced, the program's span recorder runs from the top (spans.Capture), and the
record keeps the device-only stretch's busy intervals and each device
operation's time by the program span open at its launch (train_dynamic's
tracer), and the program's counters of the stretch (train_dynamic.counters and
vertex_attention.relu_calls / .relu_pairs; absent from a program without
them).

Planted faults (tests and calibrate.py), through the attention's seam:
`goal_detached` (the goal vertices detached inside the attention, so the
gradient reaches the pose through the warps only), `vertices_halved` (the
attention over the first half of the vertices) and `radius_halved`.

A program whose `train_image_wise` takes no `step_callback` cannot run the
cell: the run stops before its set-up, with an error.
"""
from __future__ import annotations

import inspect
import os
import time

import numpy as np
import torch

from port_bench import body as body_mod
from port_bench import reference, scene, spans
from port_bench import reference_dummy_dynamic as ref_dyn
from port_bench import reference_image_wise as ref_iw
from port_bench.harness import CACHE_DIR, Outcome, flag_argv, free_program, launch_counts
from port_bench.trace import breakdown
from port_bench.traffic import train as base
from port_bench.traffic import train_dynamic as dyn

SPAN_CAPACITY = 131072
CHECKED_STEPS = 3
SPAN_NAMES = ("solver.epoch", "solver.step", "solver.forward", "solver.backward",
              "solver.optimizer", "solver.loss_read", "pass.lbs", "pass.warp", "pass.net",
              "pass.integrate")


def relu_counters() -> dict:
    """The program's counters of the normalised-ReLU attention; empty where it has none."""
    from smpl_nerf_tpu_torch.ops import vertex_attention

    return {f"vertex_attention.{name}": int(getattr(vertex_attention, name))
            for name in ("relu_calls", "relu_pairs") if hasattr(vertex_attention, name)}


class Tracer(dyn.DynTracer):
    """train_dynamic's tracer, whose device-only stretch also counts the
    normalised-ReLU attention."""

    def start(self, labelled: bool) -> None:
        super().start(labelled)
        if not labelled:
            self.relu0 = relu_counters()

    def stop(self):
        labelled = self.labelled
        summary = super().stop()
        if not labelled:
            self.counters.update({k: v - self.relu0.get(k, 0)
                                  for k, v in relu_counters().items()})
        return summary


class Seams:
    """`image_wise.make_pose_loss` and `image_wise.relu_attention_warp` while
    the run lasts: each of the first CHECKED_STEPS steps' inputs and warps
    kept, the attention's inputs at call `posed_call` (one call a step), and
    a planted fault in the attention."""

    def __init__(self, module, fault, posed_call: int):
        self.mod = module
        self.make, self.attention = module.make_pose_loss, module.relu_attention_warp
        self.fault, self.posed_call = fault, posed_call
        self.batches, self.warps = [], []
        self.calls = 0
        self.posed = {}

    def _attend(self, samples, goal, warps, radius, **k):
        """The program's attention, with the planted fault."""
        if self.fault == "goal_detached":
            goal = goal.detach()
        elif self.fault == "vertices_halved":
            goal, warps = goal[:goal.shape[0] // 2], warps[:warps.shape[0] // 2]
        elif self.fault == "radius_halved":
            radius = radius / 2.0
        elif self.fault is not None:
            raise ValueError(f"unknown fault {self.fault!r}")
        return self.attention(samples, goal, warps, radius, **k)

    def attend(self, samples, goal, warps, radius, **k):
        self.calls += 1
        if self.calls == self.posed_call:
            self.posed.update(samples=samples.detach().clone(), goal=goal.detach().clone(),
                              warps=warps.detach().clone(), radius=radius)
        out = self._attend(samples, goal, warps, radius, **k)
        if len(self.warps) < CHECKED_STEPS:
            self.warps.append(out.detach().clone())
        return out

    def goal_vjp(self, cotangent: torch.Tensor) -> torch.Tensor:
        """[V, 3]: the gradient into the goal vertices that the program's
        attention gives at the posed call's inputs under `cotangent` [R, S, 3]
        (0 where none reaches them)."""
        p = self.posed
        goal = p["goal"].clone().requires_grad_(True)
        with torch.enable_grad():
            out = self._attend(p["samples"], goal, p["warps"], p["radius"])
            g = (torch.autograd.grad(out, goal, cotangent, allow_unused=True)[0]
                 if out.requires_grad else None)
        return torch.zeros_like(goal) if g is None else g.detach()

    def make_pose_loss(self, *a, **k):
        inner = self.make(*a, **k)

        def pose_loss(pose, origins, dirs, z_vals, rgb_truth):
            if len(self.batches) < CHECKED_STEPS:
                self.batches.append({"origins": origins.clone(), "directions": dirs.clone(),
                                     "z_vals": z_vals.clone(), "rgb": rgb_truth.clone()})
            return inner(pose, origins, dirs, z_vals, rgb_truth)

        return pose_loss

    def __enter__(self):
        self.mod.make_pose_loss, self.mod.relu_attention_warp = self.make_pose_loss, self.attend
        return self

    def __exit__(self, *exc):
        self.mod.make_pose_loss, self.mod.relu_attention_warp = self.make, self.attention
        return False


class StepWindow:
    """The loop's per-step callback: records the checked steps, opens the
    window after the warm-up steps and closes it at the first step end past
    the window's length (traced: after `traced` steps on the device alone,
    then `labelled` more)."""

    def __init__(self, run, tracer, warmup: int, traced: int, labelled: int):
        self.run, self.tracer = run, tracer
        self.last_checked = max(CHECKED_STEPS, warmup)      # steps_only: the posed step too
        self.warmup, self.traced, self.labelled_steps = warmup, traced, labelled
        self.t_start = self.t_end = None
        self.steps = 0
        self.losses = []
        self.checked = {"losses": [], "grads": [], "angles": []}
        self.launches0 = self.launches = {}
        self.summary = self.labelled = None
        self.step_ends = []

    def __call__(self, step: int, loss: float, models: dict) -> bool:
        now = time.perf_counter()
        self.losses.append(loss)
        if len(self.checked["losses"]) < CHECKED_STEPS:
            est = models["smpl_estimator"]
            self.checked["losses"].append(loss)
            self.checked["grads"].append(torch.cat([est.arm_angle_l.grad,
                                                    est.arm_angle_r.grad]).detach().clone())
            self.checked["angles"].append(torch.cat([est.arm_angle_l,
                                                     est.arm_angle_r]).detach().clone())
        if self.run.steps_only and step == self.last_checked:
            return True
        if step == self.warmup:
            self.run.sync()
            self.t_start = time.perf_counter()
            self.launches0 = launch_counts()
            if self.run.trace:
                self.tracer.start(labelled=False)
            return False
        if self.t_start is None:
            return False
        if self.t_end is not None:             # the labelled steps after a traced window
            if step - self.warmup - self.steps < self.labelled_steps:
                return False
            self.labelled = self.tracer.stop()
            return True
        self.step_ends.append(now)
        if self.run.trace and step - self.warmup < self.traced:
            return False
        if not self.run.trace and now - self.t_start < self.run.seconds:
            return False
        self.t_end, self.steps = now, step - self.warmup
        self.launches = {k: v - self.launches0.get(k, 0) for k, v in launch_counts().items()}
        if not self.run.trace:
            return True
        self.summary = self.tracer.stop()
        self.tracer.start(labelled=True)
        return False


def frozen_net(flags: dict, seed: int, device) -> tuple:
    """(path of the seed's coarse-net state dict, the net's leaves): written
    once per seed under the cache, through a temporary file and a rename."""
    net = scene.lecun_weights(reference.Widths(flags).shapes(), seed, device)["model_coarse"]
    path = CACHE_DIR / "image_wise" / f"coarse_{int(seed)}.pt"
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({k: v.cpu() for k, v in net.items()}, tmp)
        os.replace(tmp, path)
    return path, net


def run(r) -> Outcome:
    from smpl_nerf_tpu_torch import config as config_mod
    from smpl_nerf_tpu_torch.training import factory
    from smpl_nerf_tpu_torch.training import image_wise

    if "step_callback" not in inspect.signature(image_wise.train_image_wise).parameters:
        raise RuntimeError("this program's train_image_wise takes no step_callback: the "
                           "image_wise_dynamic cell cannot drive its loop")
    p, flags, dev = r.params, r.flags, r.device
    body_path, body = body_mod.write_body(r.seed, CACHE_DIR)
    net_path, net = frozen_net(flags, r.seed, dev)
    seed = scene.program_seed(r.seed)
    argv = flag_argv({**flags, "smpl_model_path": str(body_path),
                      "load_coarse_model": str(net_path)})
    args = config_mod.config_parser().parse_args(argv + ["--seed", str(seed)])
    capture = spans.Capture(r.trace, SPAN_CAPACITY)
    res, n_train = int(p["resolution"]), int(p["train_views"])
    views = scene.make_views(r.seed, 11, n_train, 360.0 / n_train, p, flags["human_joints"],
                             bool(flags["white_background"]), dev, with_rgb=True)
    train_data = base._ray_data(views, slice(0, n_train), res, float(p["fov_deg"]))
    extras = factory.dataset_extras(args, train_data)
    model = extras["smpl_model"]
    sizes = {"vertices": model.num_vertices, "posedirs_columns": model.posedirs.shape[-1],
             "faces": model.faces.shape[0], "joints": model.joint_regressor.shape[0]}
    tracer = Tracer(r.trace, dev, "image_wise loop", capture)
    tracer.labels.update(SPAN_NAMES)
    window = StepWindow(r, tracer, int(p["warmup_steps"]), int(p["trace_steps"]),
                        int(p["labelled_steps"]))
    np.random.seed(seed)
    torch.manual_seed(seed)
    with Seams(image_wise, r.fault, int(p["warmup_steps"])) as seams:
        final, _ = image_wise.train_image_wise(args, None, train_data, None, extras,
                                               log_dir=None, device=dev,
                                               step_callback=window)
    r.sync()
    net_kept = all(torch.equal(final["model_coarse"][k].to(dev), v) for k, v in net.items())
    record_spans = capture.record()
    failed = int(sum(not np.isfinite(x) for x in window.losses))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    bs = int(args.batchsize)
    ours = {**window.checked, "warps": seams.warps}
    batches, posed = seams.batches, seams.posed
    del final, extras, model
    free_program()

    radius = float(flags["warp_radius"])
    cotangent = ref_iw.cotangent(posed, radius, r.seed)
    ours["goal_vjp"] = seams.goal_vjp(cotangent)
    free_program()
    arrays = ref_dyn.body_tensors(body_mod.arrays(body), dev)
    ref = ref_iw.train_steps(flags, net, arrays, batches, reference.stated_precision(flags))
    ref["goal_vjp"] = ref_iw.attention_vjp(posed, cotangent, radius)
    values = ref_iw.readings(ours, ref, ref_iw.replay_adam(flags, ours["grads"]))
    details = ref_iw.details(ours, ref) if r.steps_only else None
    control = None
    if r.control:
        ctrl = ref_iw.train_steps(flags, net, arrays, batches, "fp8")
        ctrl["goal_vjp"] = ref_iw.attention_vjp(posed, cotangent, radius, "fp8")
        control = ref_iw.readings(ctrl, ref, ref_iw.replay_adam(flags, ctrl["grads"]))
    outcome = Outcome(attempted=window.steps or len(window.losses), failed=failed,
                      end_to_end={}, readings=values, memory_peak_bytes=peak,
                      launches=window.launches, control_readings=control)
    body_note = (f"V={sizes['vertices']}, posedirs columns {sizes['posedirs_columns']}, "
                 f"faces {sizes['faces']}, joints {sizes['joints']} (seeded, SMPL pkl format)")
    outcome.notes = {"body": body_note, "frozen net unchanged": net_kept,
                     "losses of the checked steps": ours["losses"],
                     "angles after the checked steps": [a.tolist() for a in ours["angles"]],
                     "posed step": {"step": int(p["warmup_steps"]),
                                    "largest warp": float(posed["warps"].norm(dim=-1).max()),
                                    "samples held": float((cotangent != 0).any(-1).float().mean())}}
    if not net_kept:
        outcome.failed += 1
    if window.t_end is None:          # stopped after the checked steps
        outcome.notes["details"] = details
        return outcome
    window_s = window.t_end - window.t_start
    outcome.window_s = window_s
    outcome.end_to_end = {"train_rays_per_s": window.steps * bs / window_s,
                          "setup_s": window.t_start - r.t0}
    ends = [window.t_start] + window.step_ends
    outcome.notes["window"] = f"{window.steps} steps in {window_s!r} s"
    outcome.notes["step seconds (median)"] = float(np.median(np.diff(ends)))
    if r.trace and dev.type == "cuda":
        outcome.summary = window.summary
        outcome.breakdown = breakdown(window.summary, window.labelled)
        outcome.record = {"kind": "train", "flags": flags, "summary": window.summary,
                          "window_s": window_s, "steps": window.steps, "batch": bs,
                          "launches": window.launches, "vertices": sizes["vertices"],
                          "counters": tracer.counters, "kernels": tracer.attribution,
                          **record_spans}
        if tracer.attribution is not None:
            outcome.notes["device s by span"] = sorted(
                ((k, v[0], v[1]) for k, v in tracer.attribution["by_span"].items()),
                key=lambda x: -x[1])[:12]
            outcome.notes["device s unattributed"] = tracer.attribution["unattributed"]
        outcome.notes["counters of the stretch"] = tracer.counters
    return outcome
