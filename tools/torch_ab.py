"""What the kernel A/B tools share (``torch_k6_ab.py``, ``torch_k7_ab.py``):
the build of other sources of one of the port's kernels, the timing of
several builds in turns on one H100, and a device profile of one build.

Each source is built by nvcc with the port's flags into
``sparsebase_tpu_torch/_build/ab/``, beside the port's own build, all at
once; the tools then launch each build through ctypes. Timing in turns:
``2 x rounds`` samples per build, one per event pair (``chip_smoke.cuda_ms``),
forward order then reverse order, so that a drift of the card's clock
falls on every build alike.
"""
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from benchmark.core.trace import profile_calls  # noqa: E402


def nvcc(src: str) -> str:
    """Builds ``src`` with the port's nvcc flags; returns the library's path."""
    from sparsebase_tpu_torch import _build

    out = _build.BUILD_ROOT / "ab" / f"{Path(src).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o", str(out)], check=True,
                   capture_output=True, text=True, timeout=600)
    return str(out)


def start(sources) -> list:
    """Stops without a card; prints the card's name and power limit; builds
    the port and every source at once. Returns the sources' libraries."""
    from sparsebase_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        port = pool.submit(_build.build)
        libs = list(pool.map(nvcc, sources))
        port.result()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    return libs


def in_turns(kernels, call, rounds: int, reps: int = 5, prefix: str = "") -> dict:
    """Times ``call(fn)`` for each ``(name, fn)`` of ``kernels`` in turns;
    prints each build's median, range and ratio to the first build's median.
    Returns the samples by name."""
    got = {name: [] for name, _ in kernels}
    for r in range(rounds):
        order = kernels + kernels[::-1] if r % 2 == 0 else kernels[::-1] + kernels
        for name, fn in order:
            got[name].append(cs.cuda_ms(lambda: call(fn), reps=reps))
    base = kernels[0][0]
    first = statistics.median(got[base])
    for name, ms in got.items():
        med = statistics.median(ms)
        print(f"  {prefix}{name:18s} one call: median {med:.4f} ms, min {min(ms):.4f}, max {max(ms):.4f} "
              f"({med / first:.3f} x {base}); {' '.join(f'{x:.4f}' for x in ms)}")
    return got


def short(kernel: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    return kernel.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0].strip()


def device_summary(fn, runs: int) -> str:
    """The device's busy time and operations per call of ``fn`` under
    ``torch.profiler``, and each kernel's device time per call."""
    fn()
    trace, _ = profile_calls(fn, runs, torch.cuda.synchronize, 0.0)
    per_kernel = {}
    for start, end, name in trace.kernels:
        per_kernel[name] = per_kernel.get(name, 0.0) + (end - start) / 1e3 / runs
    busy = trace.busy_s() * 1e3 / runs if trace.kernels else float("nan")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return (f"device busy {busy:.4f} ms per call; {len(trace.kernels) / runs:g} device operations per call: "
            + "; ".join(f"{ms * 1e3:.1f} us {short(k)}" for k, ms in top))
