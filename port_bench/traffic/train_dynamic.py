"""Training traffic of the SMPL-driven dummy_dynamic family: the program's
own epoch loop, one caller, closed loop.

The same window, warm-up and check as traffic/train.py, whose classes it
reuses: set-up writes the run's seeded body in SMPL's pkl format
(port_bench/body.py) and hands it to the program through --smpl_model_path,
makes the views, builds the nets with the program's factory and loads the
harness's weights into them (the coarse and fine nets from
scene.lecun_weights, and the smpl_estimator's pose-table buffer: the train
views' poses), builds the pipeline and a `Solver` and calls `Solver.train`.
The first three steps are recorded as in train.py, and the first one's
vertex-attention warp besides (through the seam `pipelines.vertex_attention_warp`);
once the program is freed, reference_dummy_dynamic.train_steps repeats them
from the same weights, rows and draws: `loss_gap`, `grad_gap`, `change_gap`
as checks.train_readings reads them, and `warp_gap`.

Traced, the run turns the program's span recorder on (spans.Capture) and
keeps, of the device-only stretch, the merged busy intervals and each device
operation's time by the program span open on the host when it was launched
(the CUDA runtime call that launched it, found by the profiler's correlation
id); the record holds them with the program's counters of the stretch
(vertex_attention.calls / .pairs, smpl.lbs_calls / .lbs_poses; absent from a
program without them).

Planted faults (tests and calibrate.py), through the same seam:
`warp_skipped` (no warp), `vertices_halved` (the attention over the first half
of the vertices), `row_max` (each sample's own max in place of the global
one); and train.py's `unchanged` and `half_batch`.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import body as body_mod
from port_bench import checks, reference, scene, spans
from port_bench import reference_dummy_dynamic as ref_dyn
from port_bench.harness import CACHE_DIR, Outcome, flag_argv, free_program, launch_counts
from port_bench.trace import Tracer, _ns, breakdown, reduce
from port_bench.traffic import train as base

SPAN_CAPACITY = 131072
CHUNK = 512
ATTENTION_FAULTS = ("warp_skipped", "vertices_halved", "row_max")


def _row_max_warp(samples, goal, warps, radius, temperature, chunk_size=CHUNK):
    """The attention with each sample's own max of the logits in place of the
    global one, over chunks of vertices."""
    R, S, _ = samples.shape
    chunks = [slice(lo, min(lo + chunk_size, goal.shape[1]))
              for lo in range(0, goal.shape[1], chunk_size)]

    def att(c):
        d = torch.sqrt(((samples[:, :, None, :] - goal[:, None, c, :]) ** 2).sum(-1))
        return torch.relu(radius - d) * temperature

    m = torch.zeros((R, S), device=samples.device)
    for c in chunks:
        m = torch.maximum(m, att(c).amax(-1))
    s_exp = torch.zeros((R, S), device=samples.device)
    s_warp = torch.zeros((R, S, 3), device=samples.device)
    for c in chunks:
        e = torch.exp(att(c) - m[..., None])
        s_exp = s_exp + e.sum(-1)
        s_warp = s_warp + torch.bmm(e, warps[:, c])
    numer = s_warp - torch.exp(-m)[..., None] * warps.sum(1)[:, None, :]
    return numer / torch.clamp(s_exp[..., None], min=1e-30)


class Seam:
    """`pipelines.vertex_attention_warp` while the run lasts: the program's,
    or a planted fault, with the first call's warp kept."""

    def __init__(self, pipelines_mod, fault):
        self.mod, self.inner = pipelines_mod, pipelines_mod.vertex_attention_warp
        inner = self.inner
        if fault == "warp_skipped":
            self.fn = lambda s, g, w, r, t, **k: torch.zeros_like(s)
        elif fault == "vertices_halved":
            self.fn = lambda s, g, w, r, t, **k: inner(s, g[:, :g.shape[1] // 2],
                                                       w[:, :w.shape[1] // 2], r, t, **k)
        elif fault == "row_max":
            self.fn = _row_max_warp
        else:
            self.fn = inner
        self.first = None

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        if self.first is None:
            self.first = out.detach().clone()
        return out

    def __enter__(self):
        self.mod.vertex_attention_warp = self
        return self

    def __exit__(self, *exc):
        self.mod.vertex_attention_warp = self.inner
        return False


def counters() -> dict:
    """The program's attention and LBS counters; empty where it has none."""
    from smpl_nerf_tpu_torch.models import smpl
    from smpl_nerf_tpu_torch.ops import vertex_attention

    out = {}
    for name, mod, attr in (("vertex_attention.calls", vertex_attention, "calls"),
                            ("vertex_attention.pairs", vertex_attention, "pairs"),
                            ("smpl.lbs_calls", smpl, "lbs_calls"),
                            ("smpl.lbs_poses", smpl, "lbs_poses")):
        value = getattr(mod, attr, None)
        if value is not None:
            out[name] = int(value)
    return out


def _launch_ns(events) -> dict:
    """{correlation id: host ns} of the CUDA runtime and driver calls."""
    out = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if not name.startswith("cu"):
            continue
        for cid in (e.correlation_id(), e.linked_correlation_id()):
            if cid:
                out.setdefault(int(cid), _ns(e, "start"))
    return out


def _device_ops(events, labels) -> list:
    """(start ns, end ns, correlation ids) of the device operations (as trace.reduce keeps them)."""
    out = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        annotation = getattr(e, "is_user_annotation", None)
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.name() in labels or (annotation is not None and annotation()) or dur <= 0:
            continue
        out.append((start, start + dur, (int(e.correlation_id()), int(e.linked_correlation_id()))))
    return out


def merged(ops) -> list:
    """The union of the operations' [start, end) as sorted disjoint intervals."""
    out = []
    for s, t, _ in sorted(ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(x) for x in out]


def attribute(ops, launch_ns: dict, span_list) -> dict:
    """{'by_span': {path: [device s, operations]}, 'unattributed': [s, n]}: each
    operation's time under the program spans open when its launch was
    called (path: the span names outermost first, joined by '/')."""
    starts = [s[1] for s in span_list]
    by_span, lost = {}, [0.0, 0]
    for s, t, cids in ops:
        at = next((launch_ns[c] for c in cids if c and c in launch_ns), None)
        i = None if at is None else spans.innermost(span_list, starts, at)
        if i is None:
            lost[0] += (t - s) * 1e-9
            lost[1] += 1
            continue
        path = "/".join(reversed(spans.names_from(span_list, i)))
        entry = by_span.setdefault(path, [0.0, 0])
        entry[0] += (t - s) * 1e-9
        entry[1] += 1
    return {"by_span": by_span, "unattributed": lost}


class DynTracer(Tracer):
    """The harness's tracer, which also marks the program's spans around the
    device-only stretch and keeps its busy intervals and kernel attribution."""

    def __init__(self, enabled, device, outside, capture):
        super().__init__(enabled, device, outside)
        self.capture = capture
        self.labelled = False
        self.attribution = None
        self.counters0 = self.counters = None

    def start(self, labelled: bool) -> None:
        super().start(labelled)
        self.labelled = labelled
        if not labelled:
            self.counters0 = counters()
            self.capture.start()

    def stop(self):
        if self.labelled:
            return super().stop()
        self.capture.stop()
        self.counters = {k: v - self.counters0.get(k, 0) for k, v in counters().items()}
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        ops = _device_ops(events, self.labels)
        summary = reduce(self.prof, self.labels, self.outside)
        summary.busy_intervals = merged(ops)
        snap = self.capture.tracing.snapshot() if self.capture.enabled else None
        if snap is not None:
            self.attribution = attribute(ops, _launch_ns(events), [tuple(s) for s in snap.spans])
        self.prof = None
        return summary


def run(r) -> Outcome:
    from smpl_nerf_tpu_torch import config as config_mod
    from smpl_nerf_tpu_torch import pipelines
    from smpl_nerf_tpu_torch.ops import _build
    from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
    from smpl_nerf_tpu_torch.training import factory
    from smpl_nerf_tpu_torch.training.solver import Solver

    p, flags, dev = r.params, r.flags, r.device
    body_path, body = body_mod.write_body(r.seed, CACHE_DIR)
    argv = flag_argv({**flags, "smpl_model_path": str(body_path)})
    args = config_mod.config_parser().parse_args(
        argv + ["--seed", str(scene.program_seed(r.seed))])
    if dev.type == "cuda":
        _build.build_all()
    capture = spans.Capture(r.trace, SPAN_CAPACITY)
    res, n_train, n_val = int(p["resolution"]), int(p["train_views"]), int(p["val_views"])
    views = scene.make_views(r.seed, 11, n_train + n_val, 360.0 / (n_train + n_val), p,
                             flags["human_joints"], bool(flags["white_background"]), dev,
                             with_rgb=True)
    train_data = base._ray_data(views, slice(0, n_train), res, float(p["fov_deg"]))
    val_data = base._ray_data(views, slice(n_train, None), res, float(p["fov_deg"]))
    extras = factory.dataset_extras(args, train_data)
    model = extras["smpl_model"]
    models, encoders = factory.build_models_and_params(args, seed=args.seed, device=dev,
                                                       extras=extras)
    nets = scene.lecun_weights(reference.Widths(flags).shapes(), r.seed, dev)
    table = views["poses"][:n_train].clone()
    weights = {**nets, "smpl_estimator": {"goal_poses": table}}
    for name, m in models.items():
        m.load_state_dict(weights[name])
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
    solver = Solver(pipeline, args, log_dir=None)
    tracer = DynTracer(r.trace, dev, "Solver.train loop", capture)
    for attr in ("gather", "train_step", "_validate"):
        tracer.label(solver, attr, f"Solver.{attr}")
    tracer.label(solver.optimizer, "step", "optimizer.step")
    tracer.label(solver, "loss_fn", "loss_fn (forward)")
    tracer.label(pipeline.passes, "coarse", "passes.coarse")
    if r.fault not in ATTENTION_FAULTS:
        base._plant(r.fault, solver, pipeline)
    first = base.FirstSteps(solver, stop_after=r.steps_only)
    window = base.EpochWindow(r, tracer, int(p["warmup_epochs"]), int(p["trace_epochs"]))
    with Seam(pipelines, r.fault if r.fault in ATTENTION_FAULTS else None) as seam:
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
    warp_ours = seam.first
    val_losses = [float(v) for v in solver.history["val_loss"]]
    sizes = {"vertices": model.num_vertices, "posedirs_columns": model.posedirs.shape[-1],
             "faces": model.faces.shape[0], "joints": model.joint_regressor.shape[0]}
    first.solver = None
    del solver, pipeline, models, encoders, extras, model
    free_program()

    image = torch.arange(n_train * res * res, device=dev) // (res * res)
    flat = {k: views[k][:n_train].reshape(-1, views[k].shape[-1])
            for k in ("origins", "directions", "rgb")}
    batches = []
    for idx in first.idx:
        i = torch.as_tensor(idx, device=dev)
        batches.append({"origins": flat["origins"][i], "directions": flat["directions"][i],
                        "rgb": flat["rgb"][i], "image": image[i]})
    seed = scene.program_seed(r.seed)
    arrays = ref_dyn.body_tensors(body_mod.arrays(body), dev)
    start = {"model_coarse": nets["model_coarse"]}

    def readings(precision):
        ref = ref_dyn.train_steps(flags, nets, arrays, table, batches, seed, precision)
        out = checks.train_readings(ours, ref, start)
        out["warp_gap"] = ref_dyn.warp_gap(warp_ours, ref["warp"])
        return out, ref

    values, ref = readings(reference.stated_precision(flags))
    details = checks.train_details(ours, ref, start) if r.steps_only else None
    del ref
    control = readings("fp8")[0] if r.control else None

    outcome = Outcome(attempted=window.steps, failed=failed, end_to_end={}, readings=values,
                      memory_peak_bytes=peak, launches=launches, control_readings=control)
    body_note = (f"V={sizes['vertices']}, posedirs columns {sizes['posedirs_columns']}, "
                 f"faces {sizes['faces']}, joints {sizes['joints']} (seeded, SMPL pkl format)")
    if window.t_end is None:          # stopped after the checked steps
        outcome.notes = {"body": body_note, "details": details}
        return outcome
    window_s = window.t_end - window.t_start
    outcome.window_s = window_s
    outcome.end_to_end = {"train_rays_per_s": window.steps * bs / window_s,
                          "setup_s": window.t_start - r.t0}
    outcome.notes = {"body": body_note,
                     "window": f"{window.steps} steps ({window.epochs} epochs of "
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
                          "launches": launches, "vertices": sizes["vertices"],
                          "counters": tracer.counters, "kernels": tracer.attribution,
                          **record_spans}
        if tracer.attribution is not None:
            outcome.notes["device s by span"] = sorted(
                ((k, v[0], v[1]) for k, v in tracer.attribution["by_span"].items()),
                key=lambda x: -x[1])[:12]
            outcome.notes["device s unattributed"] = tracer.attribution["unattributed"]
        outcome.notes["counters of the stretch"] = tracer.counters
    return outcome
