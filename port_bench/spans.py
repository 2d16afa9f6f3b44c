"""The program's own spans (smpl_nerf_tpu_torch/tracing.py) over a traced
stretch's device activity.

A traced run turns the program's span recorder on from the top of its
traffic (`Capture`), marks the device-only stretch's start and stop on the
same clock (`time.time_ns()`, the Unix clock torch.profiler stamps its host
and device events with), and puts the spans, the marks and the stretch's row
counts in the record (`Capture.record`). `trace.reduce` keeps the merged busy
intervals of that stretch (`DeviceSummary.busy_intervals`).

`idle_gaps` splits the stretch's idle time by the innermost program span
open at each gap's middle, the rule `trace.reduce` uses for the harness's
labels; the span readers (port_bench/metrics/*.py) read the split. Each
returns None where the record lacks spans or busy intervals, or where the
recorder dropped spans.
"""
from __future__ import annotations

import bisect
import statistics
import time
from typing import Iterable, List, Optional, Sequence, Tuple


def row_counts() -> dict:
    """The program's rows counters beside its launch counters: kernel B's
    `fused_mlp_v2.rows`; empty for a program without it."""
    from smpl_nerf_tpu_torch.ops import fused_mlp_v2

    rows = getattr(fused_mlp_v2, "rows", None)
    return {} if rows is None else {"fused_mlp_v2_fwd": rows}


class Capture:
    """The program's spans of one traced run. `start()` and `stop()` mark the
    device-only stretch (called right after the profiler starts and right
    before it stops); `record()` turns the recorder off and returns the keys
    the span readers take."""

    def __init__(self, enabled: bool, capacity: int):
        from smpl_nerf_tpu_torch import tracing

        self.tracing = tracing
        self.enabled = enabled
        self.stretch_ns = None
        self.rows0 = self.rows = None
        if enabled:
            tracing.enable(capacity)

    def start(self) -> None:
        self.rows0 = row_counts()
        self.stretch_ns = (time.time_ns(), None)

    def stop(self) -> None:
        self.stretch_ns = (self.stretch_ns[0], time.time_ns())
        self.rows = {k: v - self.rows0[k] for k, v in row_counts().items()}

    def record(self) -> dict:
        if not self.enabled:
            return {}
        self.tracing.disable()
        snap = self.tracing.snapshot()
        return {"spans": [tuple(s) for s in snap.spans], "spans_dropped": snap.dropped,
                "stretch_ns": self.stretch_ns, "rows": self.rows}


def readable(rec, kind: str) -> bool:
    """A record of `kind` whose spans and busy intervals can be read."""
    return (rec is not None and rec.get("kind") == kind and "spans" in rec
            and rec.get("spans_dropped") == 0 and rec.get("stretch_ns") is not None
            and getattr(rec.get("summary"), "busy_intervals", None) is not None)


def innermost(spans: Sequence[tuple], starts: List[int], t: int) -> Optional[int]:
    """Index of the innermost span open at t, None if none is. Spans are in
    the order they opened, and nest (one thread): every span open at t is an
    ancestor of the last one opened by t, or that span itself."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0:
        return None
    while i is not None:
        _, _, end, parent, _ = spans[i]
        if end is None or end >= t:
            return i
        i = parent
    return None


def idle_gaps(busy: Iterable[Tuple[int, int]], spans: Sequence[tuple], lo: int,
              hi: int) -> List[Tuple[int, Optional[int]]]:
    """(ns, innermost span index or None) of every idle gap of [lo, hi): the
    time between the merged busy intervals `busy` (sorted), the stretch's
    ends included."""
    starts = [s[1] for s in spans]
    gaps, t = [], lo
    for s, e in busy:
        if e <= t:
            continue
        if s >= hi:
            break
        if s > t:
            gaps.append((t, s))
        t = e
    if t < hi:
        gaps.append((t, hi))
    return [(b - a, innermost(spans, starts, (a + b) // 2)) for a, b in gaps]


def names_from(spans: Sequence[tuple], i: Optional[int]) -> List[str]:
    """The names of span i and its ancestors, innermost first."""
    out = []
    while i is not None:
        out.append(spans[i][0])
        i = spans[i][3]
    return out


def split(rec) -> Tuple[List[Tuple[int, Optional[int]]], int]:
    """(idle gaps, stretch ns) of a readable record."""
    lo, hi = rec["stretch_ns"]
    return idle_gaps(rec["summary"].busy_intervals, rec["spans"], lo, hi), hi - lo


def idle_under_pct(rec, kind: str, names: Iterable[str]) -> Optional[float]:
    """Idle time whose innermost span is one of `names` or lies under one,
    as a share of the stretch (%)."""
    if not readable(rec, kind):
        return None
    names = set(names)
    gaps, stretch = split(rec)
    under = sum(ns for ns, i in gaps if names & set(names_from(rec["spans"], i)))
    return 100.0 * under / stretch


def idle_unnamed_pct(rec, kind: str, container: str) -> Optional[float]:
    """Idle time whose innermost span is `container` or none, as a share of
    the stretch's idle time (%)."""
    if not readable(rec, kind):
        return None
    gaps, _ = split(rec)
    idle = sum(ns for ns, _ in gaps)
    if idle == 0:
        return None
    unnamed = sum(ns for ns, i in gaps if i is None or rec["spans"][i][0] == container)
    return 100.0 * unnamed / idle


def median_ms(rec, kind: str, name: str) -> Optional[float]:
    """Median host ms of the `name` spans that start in the stretch."""
    if not readable(rec, kind):
        return None
    lo, hi = rec["stretch_ns"]
    ms = [(e - s) * 1e-6 for n, s, e, _, _ in rec["spans"]
          if n == name and e is not None and lo <= s < hi]
    return statistics.median(ms) if ms else None


def union_s(intervals: Iterable[Tuple[int, int]]) -> float:
    """Seconds covered by the union of [start, end) ns intervals."""
    total, t = 0, None
    for s, e in sorted(intervals):
        if t is None or s > t:
            total += e - s
            t = e
        elif e > t:
            total += e - t
            t = e
    return total * 1e-9

