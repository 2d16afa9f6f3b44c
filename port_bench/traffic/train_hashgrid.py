"""Training traffic of smpl_nerf on Instant-NGP's hash-grid fields: the
program's own epoch loop, one caller, closed loop.

The window, warm-up and check of traffic/train.py, whose classes it reuses:
set-up makes the views, builds the nets with the program's factory and loads
the harness's weights into them (reference_hashgrid.make_weights: the tables
uniform in +-1e-4, the layers as scene.lecun_weights draws them), builds the
pipeline and a `Solver` and calls `Solver.train`. Of the kernels it builds
kernel A alone (the fine sampling); the fields run on PyTorch. The encoding's
sizes are the configuration's `hash_grid` group (the program's
`grid_nerf.NGP_SIZES`, which no flag sets): a program whose sizes differ, or
that has none, is refused before any work. The first three steps are recorded
as in train.py, and the first training call of the coarse net's encoding
besides (its features, through the seam `grid_nerf.hash_grid_encode`); once
the program is freed, reference_hashgrid.train_steps repeats the steps from
the same weights, rows and draws: checks.train_readings, `encode_gap` (those
features against the reference's encoding of its own points of the same
rows), and step 1's gradient into each level of each table,
`coarse_table_grad_gap` and `fine_table_grad_gap` (the fine table's rows
follow the coarse net's bf16 rounding into the fine depths, so its limit is
the looser).

Traced, the run keeps the program's spans (spans.Capture) and each device
operation's time by the span open at its launch, as train_dynamic.py does;
the record's `counters` hold the program's `grid.encode_calls` and
`grid.lookups` (grid_nerf.encode_calls / .lookups) over the device-only
stretch, absent from a program without them.

Planted faults (tests and calibrate.py), through the seam: in the forward,
`primes_swapped` (pi2 and pi3 exchanged), `nearest_corner` (each level read at
the vertex nearest the point), `finest_dropped` (the finest level's features
zeroed), `table_halved` (the hashed levels taken mod T/2); in the backward
alone, the forward left as it is (`_TableGrad` around the table),
`finest_grad_dropped` (the finest level's gradient into the table zeroed),
`table_grad_halved` (every level's halved), `coarsest_grad_shifted` (level
0's moved one entry along); and train.py's `unchanged` and `half_batch`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench import checks, reference, scene, spans
from port_bench import reference_hashgrid as ref_hash
from port_bench.harness import Outcome, free_program
from port_bench.trace import breakdown
from port_bench.traffic import train as base
from port_bench.traffic import train_dynamic as dyn

SPAN_CAPACITY = 131072
ENCODE_FAULTS = ("primes_swapped", "nearest_corner", "finest_dropped", "table_halved")
GRAD_FAULTS = ("finest_grad_dropped", "table_grad_halved", "coarsest_grad_shifted")
SEAM_FAULTS = ENCODE_FAULTS + GRAD_FAULTS


class _TableGrad(torch.autograd.Function):
    """The table as it is; the backward alters the gradient of entries [lo, hi)
    as the grad fault says."""

    @staticmethod
    def forward(ctx, table, lo, hi, fault):
        ctx.rows = lo, hi, fault
        return table.view_as(table)

    @staticmethod
    def backward(ctx, grad):
        lo, hi, fault = ctx.rows
        grad = grad.clone()
        part = grad[lo:hi]
        if fault == "finest_grad_dropped":
            part.zero_()
        elif fault == "table_grad_halved":
            part.mul_(0.5)
        else:
            part.copy_(torch.roll(part, 1, 0))
        return grad, None, None, None


def planted(fault, inner):
    """`inner` (the program's encoding) with a planted fault."""
    if fault in GRAD_FAULTS:
        def rows(s):
            if fault == "table_grad_halved":
                return 0, s.entries
            level = len(s.sizes) - 1 if fault == "finest_grad_dropped" else 0
            return s.offsets[level], s.offsets[level] + s.sizes[level]
        return lambda x, t, s: inner(x, _TableGrad.apply(t, *rows(s), fault), s)
    if fault == "primes_swapped":
        return lambda x, t, s: inner(x, t, dataclasses.replace(
            s, primes=(s.primes[0], s.primes[2], s.primes[1])))
    if fault == "table_halved":
        return lambda x, t, s: inner(x, t, dataclasses.replace(s, hashmap_size=s.hashmap_size // 2))
    if fault == "finest_dropped":
        def dropped(x, t, s):
            out = inner(x, t, s)
            return torch.cat([out[:, :-s.features], torch.zeros_like(out[:, -s.features:])], 1)
        return dropped
    if fault == "nearest_corner":
        def nearest(x, t, s):
            f = s.features
            return torch.cat([inner(torch.round(x * n) / n, t, s)[:, level * f:(level + 1) * f]
                              for level, n in enumerate(s.resolutions)], 1)
        return nearest
    raise ValueError(f"unknown fault {fault!r}")


class Seam:
    """`grid_nerf.hash_grid_encode` while the run lasts: the program's, or a
    planted fault; keeps the features of the first call under autograd on the
    coarse net's table."""

    def __init__(self, grid_mod, fault, coarse_table):
        self.mod, self.inner = grid_mod, grid_mod.hash_grid_encode
        self.fn = planted(fault, self.inner) if fault else self.inner
        self.coarse_table = coarse_table
        self.first = None

    def __call__(self, x, table, spec):
        out = self.fn(x, table, spec)
        if self.first is None and table is self.coarse_table and torch.is_grad_enabled():
            self.first = out.detach().clone()
        return out

    def __enter__(self):
        self.mod.hash_grid_encode = self
        return self

    def __exit__(self, *exc):
        self.mod.hash_grid_encode = self.inner
        return False


def counters() -> dict:
    """The program's encoding counters; empty where it has none."""
    from smpl_nerf_tpu_torch.models import grid_nerf

    out = {}
    for name, attr in (("grid.encode_calls", "encode_calls"), ("grid.lookups", "lookups")):
        value = getattr(grid_nerf, attr, None)
        if value is not None:
            out[name] = int(value)
    return out


class HashTracer(dyn.DynTracer):
    """train_dynamic's tracer, whose counters of the stretch are the encoding's,
    and which ends the profiler ranges of the program's open spans before it
    stops a profile (the window closes inside `solver.epoch`:
    tracing.end_ranges; a program without it is left as it is)."""

    def start(self, labelled: bool) -> None:
        if not labelled:
            self.grid0 = counters()
        super().start(labelled)

    def stop(self):
        from smpl_nerf_tpu_torch import tracing

        end_ranges = getattr(tracing, "end_ranges", None)
        if end_ranges is not None:
            end_ranges()
        labelled = self.labelled
        if not labelled:
            grid = {k: v - self.grid0.get(k, 0) for k, v in counters().items()}
        summary = super().stop()
        if not labelled:
            self.counters = grid
        return summary


def run(r) -> Outcome:
    from smpl_nerf_tpu_torch.models import grid_nerf
    from smpl_nerf_tpu_torch.ops import _build
    from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
    from smpl_nerf_tpu_torch.training import factory
    from smpl_nerf_tpu_torch.training.solver import Solver

    p, dev = r.params, r.device
    sizes = {**r.workload.config["hash_grid"], **r.overrides.get("hash_grid", {})}
    if getattr(grid_nerf, "NGP_SIZES", None) != sizes:
        raise RuntimeError(f"the program's hash-grid sizes "
                           f"{getattr(grid_nerf, 'NGP_SIZES', None)} are not the "
                           f"configuration's {sizes}")
    flags = {**r.flags, "hash_grid": sizes}          # what the reference and counts read
    args = r.program_args()
    if dev.type == "cuda":
        _build.build_all(["sample_pdf"])
    capture = spans.Capture(r.trace, SPAN_CAPACITY)
    res, n_train, n_val = int(p["resolution"]), int(p["train_views"]), int(p["val_views"])
    views = scene.make_views(r.seed, 11, n_train + n_val, 360.0 / (n_train + n_val), p,
                             flags["human_joints"], bool(flags["white_background"]), dev,
                             with_rgb=True)
    train_data = base._ray_data(views, slice(0, n_train), res, float(p["fov_deg"]))
    val_data = base._ray_data(views, slice(n_train, None), res, float(p["fov_deg"]))
    extras = factory.dataset_extras(args, train_data)
    models, encoders = factory.build_models_and_params(args, seed=args.seed, device=dev,
                                                       extras=extras)
    want = (tuple(ref_hash.resolutions(flags)), tuple(ref_hash.level_sizes(flags)))
    for name in ("model_coarse", "model_fine"):
        spec = models[name].spec
        if (spec.resolutions, spec.sizes) != want:
            raise RuntimeError(f"{name}'s levels {spec.resolutions} / {spec.sizes} are not {want}")
    weights = ref_hash.make_weights(flags, r.seed, dev)
    for name, model in models.items():
        model.load_state_dict(weights[name])
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
    solver = Solver(pipeline, args, log_dir=None)
    tracer = HashTracer(r.trace, dev, "Solver.train loop", capture)
    for attr in ("gather", "train_step", "_validate"):
        tracer.label(solver, attr, f"Solver.{attr}")
    tracer.label(solver.optimizer, "step", "optimizer.step")
    tracer.label(solver, "loss_fn", "loss_fn (forward)")
    tracer.label(pipeline.passes, "coarse", "passes.coarse")
    tracer.label(pipeline.passes, "fine", "passes.fine")
    if r.fault not in SEAM_FAULTS:
        base._plant(r.fault, solver, pipeline)
    first = base.FirstSteps(solver, stop_after=r.steps_only)
    window = base.EpochWindow(r, tracer, int(p["warmup_epochs"]), int(p["trace_epochs"]))
    fault = r.fault if r.fault in SEAM_FAULTS else None
    with Seam(grid_nerf, fault, models["model_coarse"].hash_table) as seam:
        try:
            solver.train(train_data, val_data, callback=window)
        except base.WindowClosed:
            pass
    r.sync()
    record_spans = capture.record()
    launches = window.launches
    failed = int(sum(not np.isfinite(x) for x in window.losses))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    bs = int(args.batchsize)
    steps_per_epoch = max(1, train_data.num_rays // bs)
    val_batches = -(-val_data.num_rays // int(args.batchsize_val))
    ours = first.program()
    encoded = seam.first
    val_losses = [float(v) for v in solver.history["val_loss"]]
    first.solver = None
    del solver, pipeline, models, encoders, seam
    free_program()

    image = torch.arange(n_train * res * res, device=dev) // (res * res)
    flat = {k: views[k][:n_train].reshape(-1, views[k].shape[-1])
            for k in ("origins", "directions", "rgb")}
    batches = []
    for idx in first.idx:
        i = torch.as_tensor(idx, device=dev)
        batches.append({"origins": flat["origins"][i], "directions": flat["directions"][i],
                        "rgb": flat["rgb"][i], "poses": views["poses"][image[i]]})
    seed = scene.program_seed(r.seed)
    ref = ref_hash.train_steps(flags, weights, batches, seed, reference.stated_precision(flags))
    readings = checks.train_readings(ours, ref, weights)
    table, points = weights["model_coarse"]["hash_table"], ref["points1"]
    readings["encode_gap"] = ref_hash.encode_gap(points, encoded, table, flags)
    for side in ("coarse", "fine"):
        readings[f"{side}_table_grad_gap"] = ref_hash.table_grad_gap(
            ours["grad1"], ref["grad1"], flags, f"model_{side}")
    details = checks.train_details(ours, ref, weights) if r.steps_only else None
    control = None
    if r.control:
        fp8 = ref_hash.train_steps(flags, weights, batches, seed, "fp8")
        control = checks.train_readings(fp8, ref, weights)
        control["encode_gap"] = ref_hash.encode_gap(
            points, ref_hash.control_encoding(points, table, flags), table, flags)
        for side in ("coarse", "fine"):
            control[f"{side}_table_grad_gap"] = ref_hash.table_grad_gap(
                fp8["grad1"], ref["grad1"], flags, f"model_{side}")
        del fp8
    del ref, encoded

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
                          "launches": launches, "counters": tracer.counters,
                          "kernels": tracer.attribution, **record_spans}
        if tracer.attribution is not None:
            outcome.notes["device s by span"] = sorted(
                ((k, v[0], v[1]) for k, v in tracer.attribution["by_span"].items()),
                key=lambda x: -x[1])[:12]
            outcome.notes["device s unattributed"] = tracer.attribution["unattributed"]
        outcome.notes["counters of the stretch"] = tracer.counters
    return outcome
