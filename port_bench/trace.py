"""The traced run's reduction: device activity from torch.profiler (CUPTI).

A traced run profiles two stretches of its loop one after the other. The
first records the device alone (CUPTI's kernel, copy and set records, which
cost the host little): the busy seconds (the union of every device
operation), the kernels by name and the launch count, from which the
per-layer metrics are read. The second records the host's operations too,
with the labels `Tracer` puts (`record_function`) around the calls the
harness makes and around bound methods of objects it holds (`label`; no
module of the program is patched), and gives only the breakdown's idle
gaps: the idle time between device operations by what the host was doing
then (the innermost label open at the gap's middle). Recording every host
operation slows a step by about half, so no metric is read from it.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


def label(obj, attr: str, name: str) -> None:
    """Wrap the bound method obj.attr (on this instance only) in a label."""
    inner = getattr(obj, attr)

    @functools.wraps(inner)
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return inner(*a, **k)

    setattr(obj, attr, wrapped)


class LabelledCall:
    """A callable that forwards to `inner` inside a label and exposes its
    attributes (the pipeline object handed to render_rays_batched)."""

    def __init__(self, inner, name: str):
        self._inner, self._name = inner, name

    def __call__(self, *a, **k):
        with torch.profiler.record_function(self._name):
            return self._inner(*a, **k)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")()) * 1000


class DeviceSummary:
    """What the device did in a traced window."""

    def __init__(self, busy_s: float, kernels: Dict[str, Tuple[float, int]], launches: int,
                 idle_by_label: Dict[str, Tuple[float, int]]):
        self.busy_s = busy_s
        self.kernels = kernels            # name -> (device seconds, count), copies included
        self.launches = launches          # kernels only (no copies or sets)
        self.idle_by_label = idle_by_label

    def kernel_seconds(self, *fragments: str) -> float:
        """Device seconds of the kernels whose name holds any of `fragments`."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(f in name for f in fragments))



def breakdown(device: DeviceSummary, labelled: DeviceSummary, top: int = 10) -> dict:
    """The device operations that took most time (the device-only stretch)
    and the idle time by what the host was doing (the labelled stretch)."""
    ops = sorted(device.kernels.items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(labelled.idle_by_label.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[name, s] for name, (s, _) in ops],
            "idle_gaps": [[f"{name} ({n} gaps)", s] for name, (s, n) in gaps]}


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def reduce(prof, labels, outside: str) -> DeviceSummary:
    """Reduce a stopped torch.profiler.profile to a DeviceSummary; `labels`
    are the names the harness gave its record_function ranges, `outside`
    names an idle gap that no label covers."""
    labels = set(labels)
    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", None)
            if name in labels or (annotation is not None and annotation()) or dur <= 0:
                continue
            device.append((start, start + dur, name))
        elif name in labels:
            host.append((start, start + dur, name))
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    launches = 0
    for s, t, name in device:
        kernels[name][0] += (t - s) * 1e-9
        kernels[name][1] += 1
        launches += not _is_copy(name)
    device.sort()
    merged: List[List[int]] = []
    for s, t, _ in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    host.sort()
    starts = [s for s, _, _ in host]
    idle: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = outside
        while i >= 0:
            if host[i][1] >= mid:
                name = host[i][2]
                break
            i -= 1
        idle[name][0] += (b - a) * 1e-9
        idle[name][1] += 1
    return DeviceSummary(busy * 1e-9, {k: (v[0], v[1]) for k, v in kernels.items()}, launches,
                         {k: (v[0], v[1]) for k, v in idle.items()})


class Tracer:
    """The profiled stretches of a traced run, started and stopped by the
    traffic: `start(labelled)` ... `stop()` returns their DeviceSummary."""

    def __init__(self, enabled: bool, device: torch.device, outside: str):
        self.enabled = enabled
        self.outside = outside
        self.device = device
        self.labels: set = set()
        self.prof = None

    def label(self, obj, attr: str, name: str) -> None:
        if self.enabled:
            self.labels.add(name)
            label(obj, attr, name)

    def wrap(self, fn, name: str):
        if not self.enabled:
            return fn
        self.labels.add(name)
        return LabelledCall(fn, name)

    def region(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        self.labels.add(name)
        return torch.profiler.record_function(name)

    def start(self, labelled: bool) -> None:
        """Profile the device, and with `labelled` the host's operations too."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if labelled or self.device.type != "cuda" else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> DeviceSummary:
        self.prof.stop()
        summary = reduce(self.prof, self.labels, self.outside)
        self.prof = None
        return summary
