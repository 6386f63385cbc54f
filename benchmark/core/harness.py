"""One run of one cell: set-up, the measured (or traced) window, the
comparison, and the result line.

The cell's pieces come from :class:`benchmark.core.spec.Spec` by name: the
configuration's generator makes the inputs on the device from the seed,
the traffic mix names the call that the window drives, and each metric has
a reader of its own. The run never reads the program's output before the
window has closed; then the process's peak memory is read, the program's
state is dropped, and the plain reference, worked out from the same
inputs, judges the last call's output.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from . import trace as tracing
from .spec import Spec
from .stats import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "sparsebase_tpu")  # top-level names, compared whole
MARGIN_S = 1.0  # the profiler held open before and after the traced calls
WARMUP_CALLS = 2  # calls before the window: the first builds and loads, the second runs warm
TRACE_CALLS = 5  # calls under the profiler in a traced run


class ForbiddenModules(RuntimeError):
    """The process holds JAX or the JAX package."""


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _check_modules() -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"the process holds modules it may not: {', '.join(found[:20])}")


class Cell:
    """A workload's configuration, traffic mix, call, generator and limits."""

    def __init__(self, spec: Spec, workload: str, overrides: Optional[Dict[str, Any]] = None):
        self.spec = spec
        self.name = workload
        self.entry = spec.cell(workload)
        self.config = dict(spec.config(self.entry["config"]), **(overrides or {}))
        self.traffic = spec.traffic(self.entry["traffic"])
        self.call = spec.module("calls", self.traffic["call"])
        self.gen = spec.module("gen", self.config["generator"])
        self.limits = spec.limits(workload)

    def inputs(self, seed: int, dev: torch.device) -> Dict[str, Any]:
        return self.gen.make(self.config, seed, dev)

    def numbers(self, got, inputs) -> Dict[str, float]:
        return self.call.judge(got, inputs, self.traffic)

    def checks(self, numbers: Dict[str, float]) -> Dict[str, Dict[str, float]]:
        return {name: {"value": value, "limit": self.limits[name]} for name, value in numbers.items()}


def _sync(dev: torch.device) -> Callable[[], None]:
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def _memory(dev: torch.device, what: str) -> Optional[int]:
    if dev.type != "cuda":
        return None
    return getattr(torch.cuda, what)(dev)


def set_up(cell: Cell, seed: int, dev: torch.device):
    """Inputs from the seed, the call's state, and the warm-up calls; the
    kernels are built or loaded first."""
    if dev.type == "cuda":
        from sparsebase_tpu_torch import _build

        _build.library()
    sync = _sync(dev)
    inputs = cell.inputs(seed, dev)
    state = cell.call.prepare(inputs, cell.traffic)
    for _ in range(WARMUP_CALLS):
        out = cell.call.run(state)
        sync()
        del out
    return inputs, state


def run(workload: str, seed: int, seconds: float, traced: bool, *, process_start: float,
        dev: Optional[torch.device] = None, spec: Optional[Spec] = None, control: bool = False,
        overrides: Optional[Dict[str, Any]] = None, margin_s: float = MARGIN_S) -> Dict[str, Any]:
    """The result line of one run (see ``benchmark/run.py``). ``control``
    puts the reference, computed in the precision below the configuration's,
    in the program's place for the comparison."""
    spec = spec or Spec()
    dev = dev or torch.device("cuda", 0)
    cell = Cell(spec, workload, overrides)
    sync = _sync(dev)
    inputs, state = set_up(cell, seed, dev)
    sync()
    setup_peak = _memory(dev, "max_memory_allocated")
    base = _memory(dev, "memory_allocated")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics: Dict[str, Dict[str, Any]] = {}
    extra: Dict[str, Any] = {}
    if not traced:
        t0 = time.perf_counter()
        setup_s = t0 - process_start
        call_s, out = [], None
        while True:
            out = None  # one call's output held at a time
            start = time.perf_counter()
            out = cell.call.run(state)
            sync()
            end = time.perf_counter()
            call_s.append(end - start)
            if end - t0 >= seconds:
                break
        peak = _memory(dev, "max_memory_allocated")
        attempted = len(call_s)
        window = Window(call_s, end - t0, cell.call.work(inputs, cell.traffic), setup_s, peak, base)
        for m in spec.end_to_end(workload):
            value = spec.module("e2e", m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr, out = tracing.profile_calls(lambda: cell.call.run(state), TRACE_CALLS, sync, margin_s)
        peak = _memory(dev, "max_memory_allocated")
        attempted = TRACE_CALLS
        if dev.type == "cuda":
            tr.syncs_per_call = float(tracing.count_host_syncs(lambda: cell.call.run(state)))
        shapes = cell.call.shapes(inputs, cell.traffic)
        for m in spec.per_layer(workload):
            value = spec.module("metrics", m["name"]).read(tr, shapes)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr.kernels:
            extra["busy_s"], extra["window_s"] = tr.busy_s(), tr.window_s
            breakdown = tracing.breakdown(tr)
    _check_modules()
    memory_peak = None if peak is None else max(peak, setup_peak)
    del state
    got = cell.call.tensors(out)
    del out
    gc.collect()
    if control:
        got = cell.call.control(inputs, cell.traffic)
    numbers = cell.numbers(got, inputs)
    checks = cell.checks(numbers)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell.entry["chips"]), "memory_peak_bytes": memory_peak}
    device.update(extra)
    line = {"correct": correct, "attempted": attempted, "failed": 0 if correct else 1, "metrics": metrics,
            "device": device, "entries_per_call": cell.call.work(inputs, cell.traffic)}
    if traced and "busy_s" in extra:
        line["breakdown"] = breakdown
    line["checks"] = checks
    _check_modules()
    return line

