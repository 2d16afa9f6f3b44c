"""Novel-view traffic: one caller renders views one after another (closed loop).

Set-up makes a pool of `pool_views` views of `resolution`^2 rays on the
host, as a camera path arrives (render_path's arrays): cameras that follow
each other by `step_deg` along the circle, each with its own arm angle
(scene.py). It builds the nets with the program's factory, loads the
harness's weights, builds the pipeline once, and renders `warmup_views`
views of their own. The window then renders the pool's views in order, each
one call of `render/batched.render_rays_batched` in batches of `batch_rays`
through the full renderer, and times each call from its start to the host
array it returns. It closes after the first view that ends past `--seconds`
(after `trace_views` views when traced, which then render `label_views` more
with the host's labels for the breakdown; trace.py).

Once the window has closed and the program is freed, `sample_views` views
drawn from the seed among those the window rendered are rendered again by
the reference and compared pixel by pixel.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import checks, reference, scene
from port_bench.harness import Outcome, free_program, launch_counts
from port_bench.trace import Tracer, breakdown

FAULT_OFFSET = 1.0 / 32.0


class _Planted:
    """The pipeline with a planted fault (tests and calibrate.py only)."""

    def __init__(self, inner, fault: str):
        if fault not in ("half_batch", "altered"):
            raise ValueError(f"unknown fault {fault!r}")
        self._inner, self._fault = inner, fault

    def __call__(self, batch, *a, **k):
        if self._fault == "altered":
            out = self._inner(batch, *a, **k)
            return {**out, "rgb_fine": out["rgb_fine"] + FAULT_OFFSET}
        n = batch["ray_translation"].shape[0]
        half = {key: v[:n // 2] if torch.is_tensor(v) and v.shape[:1] == (n,) else v
                for key, v in batch.items()}
        out = self._inner(half, *a, **k)
        rgb = out["rgb_fine"]
        return {**out, "rgb_fine": torch.cat([rgb, rgb])[:n]}

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def run(r) -> Outcome:
    from smpl_nerf_tpu_torch.data.datasets import RayData
    from smpl_nerf_tpu_torch.ops import _build
    from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
    from smpl_nerf_tpu_torch.render.batched import render_rays_batched
    from smpl_nerf_tpu_torch.training import factory

    p, flags, dev = r.params, r.flags, r.device
    if dev.type == "cuda":
        _build.build_all()
    args = r.program_args()
    res, bs = int(p["resolution"]), int(p["batch_rays"])
    n_pool, n_warm = int(p["pool_views"]), int(p["warmup_views"])
    hw = res * res
    pool = scene.make_views(r.seed, 12, n_pool + n_warm, float(p["step_deg"]), p,
                            flags["human_joints"], bool(flags["white_background"]), dev,
                            with_rgb=False)
    origins = pool["origins"].cpu().numpy()
    dirs = pool["directions"].cpu().numpy()
    poses = pool["poses"].cpu().numpy()
    cams = pool["cams"].cpu().numpy()
    image_indices = np.zeros(hw, np.int32)
    f = scene.focal(res, float(p["fov_deg"]))

    def view(i: int) -> RayData:
        return RayData(origins=origins[i], directions=dirs[i], image_indices=image_indices,
                       h=res, w=res, focal=f, num_images=1, camera_transforms=cams[i:i + 1],
                       human_poses=poses[i:i + 1])

    extras = factory.dataset_extras(args, view(0))
    models, encoders = factory.build_models_and_params(args, seed=args.seed, device=dev,
                                                       extras=extras)
    centre = bool(r.workload.cell["centre_density"])
    weights = scene.make_weights(flags, r.seed, pool, dev, centre)
    for name, model in models.items():
        model.load_state_dict(weights[name])
    pipeline = build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
    tracer = Tracer(r.trace, dev, outside="views loop")
    tracer.label(pipeline.passes, "coarse", "passes.coarse")
    tracer.label(pipeline.passes, "fine", "passes.fine")
    renderer = tracer.wrap(pipeline, "pipeline")
    if r.fault is not None:
        renderer = _Planted(renderer, r.fault)
    for i in range(n_pool, n_pool + n_warm):
        render_rays_batched(renderer, view(i), bs, dev)
    r.sync()

    limit = int(p["trace_views"]) if r.trace else (int(p["sample_views"]) if r.steps_only
                                                    else None)
    images, latency = [], []

    def render(i: int) -> None:
        t = time.perf_counter()
        with tracer.region("render_rays_batched"):
            images.append(render_rays_batched(renderer, view(i % n_pool), bs, dev))
        latency.append(time.perf_counter() - t)

    launches0 = launch_counts()
    if r.trace:
        tracer.start(labelled=False)
    t_start = time.perf_counter()
    while True:
        render(len(images))
        t_end = time.perf_counter()
        if (len(images) >= limit if limit is not None else t_end - t_start >= r.seconds):
            break
    window_s = t_end - t_start
    n_views = len(images)
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}
    summary = labelled = None
    if r.trace:
        summary = tracer.stop()
        tracer.start(labelled=True)
        for _ in range(int(p["label_views"])):
            render(len(images))
        labelled = tracer.stop()
    failed = int(sum(not np.all(np.isfinite(img)) for img in images))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del pipeline, renderer, models, encoders
    free_program()

    rng = np.random.default_rng(scene.stream_seed(r.seed, 13))
    sample = sorted(rng.choice(n_views, size=min(int(p["sample_views"]), n_views),
                               replace=False).tolist())
    gaps, control = [], []
    precision = reference.stated_precision(flags)
    for i in sample:
        k = i % n_pool
        o, d, pose = pool["origins"][k], pool["directions"][k], pool["poses"][k]
        ref = reference.render_view(flags, weights, o, d, pose, precision)
        gaps.append(checks.view_gap(torch.as_tensor(images[i], device=dev), ref))
        if r.control:
            control.append(checks.view_gap(reference.render_view(flags, weights, o, d, pose,
                                                                 "fp8"), ref))
    batches = -(-hw // bs)
    lat_ms = np.asarray(latency) * 1e3
    outcome = Outcome(attempted=n_views, failed=failed, readings={"view_gap": max(gaps)},
                      end_to_end={"view_ms": window_s * 1e3 / n_views,
                                  "view_ms_p95": float(np.percentile(lat_ms, 95)),
                                  "setup_s": t_start - r.t0},
                      window_s=window_s, memory_peak_bytes=peak, launches=launches,
                      control_readings={"view_gap": max(control)} if control else None)
    outcome.notes = {"window": f"{n_views} views in {window_s!r} s, latency ms median "
                               f"{float(np.median(lat_ms))!r} max {float(lat_ms.max())!r}",
                     "view gaps of the sample": gaps}
    if r.trace and dev.type == "cuda":
        outcome.summary = summary
        outcome.breakdown = breakdown(summary, labelled)
        outcome.record = {"kind": "views", "flags": flags, "summary": summary,
                          "window_s": window_s, "views": n_views, "view_rays": hw,
                          "eval_rays": n_views * hw, "eval_batches": n_views * batches,
                          "eval_padded_rays": n_views * batches * bs, "launches": launches}
    return outcome
