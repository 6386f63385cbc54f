"""The traced run's readings: device intervals from ``torch.profiler``, the
host's syncs, and the arithmetic that per-layer readers share.

``device_busy`` and ``count_host_syncs`` are frozen copies of
``chip_smoke.py``'s; ``profile_calls`` is its ``device_profile``, holding
the profiler open ``margin_s`` before and after the calls (in a process
older than a minute the profiler drops a short window's kernels otherwise).
The calls run inside the benchmark's own ``record_function`` span
``bench:window``, whose interval is the traced window.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

WINDOW_SPAN = "bench:window"
ANNOTATION_PREFIXES = ("bench:", "sbtorch:")  # record_function labels: ranges, not device work
KERNELS_JSON = Path(__file__).resolve().parents[1] / "kernels.json"

Interval = Tuple[float, float, str]  # start µs, end µs, name


@dataclasses.dataclass
class Trace:
    """What one traced window recorded. Times are µs on the profiler's clock."""

    calls: int
    window: Tuple[float, float]
    kernels: List[Interval]  # device operations: kernels, copies, fills
    annotations: List[Interval]  # record_function ranges as the device ran them
    host_ops: List[Interval]  # operations open on the host
    syncs_per_call: Optional[float] = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return union_us(self.kernels, *self.window) / 1e6

    def kernel_s(self, kernel_class: str) -> float:
        """Device seconds of the kernels of one class of ``kernels.json``
        (``"K4"``) in the window."""
        names = kernel_table()[kernel_class]["kernels"]
        pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")
        return sum(clip(iv, *self.window) for iv in self.kernels if pattern.search(iv[2])) / 1e6

    def inside_s(self, span: str) -> Optional[float]:
        """Device seconds of the operations that ran inside the device ranges
        of the ``record_function`` span ``span``; None where the span never
        ran on the device."""
        ranges = [a for a in self.annotations if a[2] == span]
        if not ranges:
            return None
        return sum(union_us(self.kernels, max(lo, self.window[0]), min(hi, self.window[1]))
                   for lo, hi, _ in ranges) / 1e6


def kernel_table() -> Dict[str, dict]:
    return json.loads(KERNELS_JSON.read_text())


def clip(iv: Interval, lo: float, hi: float) -> float:
    return max(0.0, min(iv[1], hi) - max(iv[0], lo))


def union_us(spans: Sequence[Interval], lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """Length of the union of the intervals, inside [lo, hi]."""
    return device_busy(sorted((max(s, lo), min(e, hi), n) for s, e, n in spans if e > lo and s < hi))[0]


def device_busy(spans: Sequence[Interval]):
    """The union of the sorted device intervals (µs), and the holes in it as
    ``(µs, kernel before, kernel after)``."""
    if not spans:
        return 0.0, []
    busy_us, gaps = 0.0, []
    reach, last = spans[0][0], spans[0][2]
    for start, end, name in spans:
        if start > reach:
            gaps.append((start - reach, last, name))
        busy_us += max(0.0, end - max(start, reach))
        if end > reach:
            reach, last = end, name
    return busy_us, gaps


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The holes in the device's work inside the window, as ``(start, end)``
    µs, the window's edges included."""
    lo, hi = trace.window
    spans = sorted((max(s, lo), min(e, hi), n) for s, e, n in trace.kernels if e > lo and s < hi)
    out, reach = [], lo
    for start, end, _ in spans:
        if start > reach:
            out.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        out.append((reach, hi))
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by the
    innermost host operation open at the middle of each gap (seconds over
    the window)."""
    ops: Dict[str, float] = {}
    for iv in trace.kernels:
        ops[iv[2]] = ops.get(iv[2], 0.0) + clip(iv, *trace.window) / 1e6
    idle: Dict[str, float] = {}
    for lo, hi in idle_gaps(trace):
        mid = (lo + hi) / 2
        open_ops = [h for h in trace.host_ops if h[0] <= mid <= h[1]]
        name = min(open_ops, key=lambda h: h[1] - h[0])[2] if open_ops else "(no host operation open)"
        idle[name] = idle.get(name, 0.0) + (hi - lo) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def _is_annotation(ev) -> bool:
    return bool(getattr(ev, "is_user_annotation", False)) or ev.name.startswith(ANNOTATION_PREFIXES)


def profile_calls(fn: Callable[[], object], calls: int, sync: Callable[[], None], margin_s: float) -> Tuple[Trace, object]:
    """Run ``fn`` ``calls`` times under ``torch.profiler`` inside the span
    ``bench:window``, synchronising after each call; the trace, and the
    last call's output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = None
    with profile(activities=activities) as prof:
        time.sleep(margin_s)
        with record_function(WINDOW_SPAN):
            for _ in range(calls):
                out = None
                out = fn()
                sync()
        time.sleep(margin_s)
    kernels, annotations, host_ops, window = [], [], [], None
    for ev in prof.events():
        iv = (float(ev.time_range.start), float(ev.time_range.end), ev.name)
        if ev.device_type == DeviceType.CPU:
            if ev.name == WINDOW_SPAN:
                window = iv[:2]
            elif not ev.name.startswith("bench:"):
                host_ops.append(iv)
        elif _is_annotation(ev):
            annotations.append(iv)
        else:
            kernels.append(iv)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN} span")
    return Trace(calls, window, sorted(kernels), sorted(annotations), host_ops), out


def count_host_syncs(fn: Callable[[], object]) -> int:
    """Synchronising CUDA operations that one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    del out
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
