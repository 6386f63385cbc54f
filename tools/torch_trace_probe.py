"""Which shape of ``torch.profiler`` window records the device's kernels: one
short traced region (the experiment's traced run) profiled several ways on
one card, each way once a round in turns, counting the Chrome trace's
``cat == "kernel"`` events and the profiler's CUDA events, and each kept
kernel's start less the host time of its launch (the ``cuda_runtime`` event
of the same correlation id): the skew between the two clocks the trace
joins. The rounds start at the process ages given (seconds), so that a
skew that grows with the process's age shows.

    python3 tools/torch_trace_probe.py [--n 2000000] [--deg 16] [--ages 0,0,0] [--ways bare,...] [--out DIR]

The traced region is what ``chip_smoke.py``'s traced experiment runs:
``torch.ones`` of the vector (a fill kernel) and K2 (``csr_spmv``) on a
synthetic graph (``bench_suite.synthetic_graph(n, deg)``), then a
synchronise. The ways:

* ``bare``: ``profile(CPU, CUDA)`` around the region;
* ``sync_first``: the same, with a ``torch.cuda.synchronize()`` on entry;
* ``sleep_first``: the same, with ``torch.cuda._sleep`` of 10M cycles and a
  synchronise on entry (work on the device before the region);
* ``warmup_step``: a schedule of one warm-up step (tracing on, results
  dropped) then one recorded step: a synchronise, ``prof.step()``, the region;
* ``padded``, ``after_1s``, ``both_3s``: ``bare`` with host sleep inside
  the window: 50 ms before and after the region, 1 s after it, 3 s before
  and after;
* ``trace_to``: the package's ``experiment.trace_to``.

Prints one line per traced window and a JSON summary as the last line.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def region(csr):
    from sparsebase_tpu_torch.ops.kernels import csr_spmv

    y = csr_spmv(csr, torch.ones((csr.ncols,), device=csr.indptr.device))
    torch.cuda.synchronize()
    return y


def read_trace(path):
    """The trace's categories, its kernels' names and each kernel's start
    less its launch's host time (µs)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats = Counter(str(ev.get("cat")) for ev in events)
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    launch = {ev["args"].get("correlation"): ev["ts"] for ev in events
              if ev.get("cat") == "cuda_runtime" and "args" in ev}
    skews = [round(float(k["ts"]) - float(launch[k["args"]["correlation"]]), 1) for k in kernels
             if k.get("args", {}).get("correlation") in launch]
    return cats, sorted({str(k.get("name"))[:50] for k in kernels}), skews


def cuda_events(prof):
    from torch.autograd import DeviceType

    return sum(1 for ev in prof.events() if ev.device_type == DeviceType.CUDA)


def way_bare(csr, out, sync_first=False):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if sync_first:
            torch.cuda.synchronize()
        with record_function("region"):
            region(csr)
    prof.export_chrome_trace(out)
    return cuda_events(prof)


def way_padded(csr, out, before=0.05, after=0.05):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(before)
        with record_function("region"):
            region(csr)
        time.sleep(after)
    prof.export_chrome_trace(out)
    return cuda_events(prof)


def way_sleep_first(csr, out):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000_000)
        torch.cuda.synchronize()
        with record_function("region"):
            region(csr)
    prof.export_chrome_trace(out)
    return cuda_events(prof)


def way_warmup_step(csr, out):
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(out)) as prof:
        torch.cuda.synchronize()
        prof.step()
        with record_function("region"):
            region(csr)
    return cuda_events(prof)


def way_trace_to(csr, out):
    from sparsebase_tpu_torch.experiment import trace_to

    d = os.path.dirname(out)
    name = os.path.basename(out)[:-5]
    with trace_to(d, name):
        region(csr)
    os.replace(os.path.join(d, name, "trace.json"), out)
    return -1


WAYS = {
    "bare": way_bare,
    "sync_first": lambda csr, out: way_bare(csr, out, sync_first=True),
    "sleep_first": way_sleep_first,
    "warmup_step": way_warmup_step,
    "padded": way_padded,
    "after_1s": lambda csr, out: way_padded(csr, out, 0.0, 1.0),
    "both_3s": lambda csr, out: way_padded(csr, out, 3.0, 3.0),
    "trace_to": way_trace_to,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--ages", default="0,0,0", help="each round's start, seconds after the graph is made")
    ap.add_argument("--ways", default=",".join(WAYS), help="the ways to try, in this order")
    ap.add_argument("--out", default=None, help="where the traces go (default: a new temporary directory)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_trace_probe: no CUDA device")
    from sparsebase_tpu_torch import bench_suite

    if args.out is None:
        args.out = tempfile.mkdtemp(prefix="trace_probe_")
    os.makedirs(args.out, exist_ok=True)
    csr = bench_suite.synthetic_graph(args.n, args.deg, device="cuda")
    region(csr)  # builds and loads K2
    print(f"graph n={csr.nrows} entries={csr.nnz}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ways = {name: WAYS[name] for name in args.ways.split(",")}
    summary = {name: [] for name in ways}
    born = time.perf_counter()
    for r, age in enumerate(float(a) for a in args.ages.split(",")):
        time.sleep(max(0.0, age - (time.perf_counter() - born)))
        print(f"round {r} at {time.perf_counter() - born:.1f} s")
        for name, way in ways.items():
            out = os.path.join(args.out, f"{name}_{r}.json")
            t0 = time.perf_counter()
            n_cuda = way(csr, out)
            ms = (time.perf_counter() - t0) * 1e3
            cats, kernels, skews = read_trace(out)
            summary[name].append(len(kernels))
            print(f"round {r} {name}: {ms:.1f} ms, profiler CUDA events {n_cuda}, trace categories "
                  f"{dict(cats)}, kernels {kernels}, kernel start less launch (µs) {skews}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
