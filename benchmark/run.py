"""The benchmark of ``sparsebase_tpu_torch`` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port. The cell's inputs are made on the card from ``--seed``, the
warm-up calls build and load everything, then:

* ``--trace 0``: calls back to back for ``--seconds`` seconds, each ending
  in ``torch.cuda.synchronize()``; the cell's end-to-end metrics;
* ``--trace 1``: a few calls under ``torch.profiler``; the per-layer
  metrics, the device's busy and window seconds, and a breakdown.

The last call's output is then compared with the plain reference
(``benchmark/reference``). Standard error ends with each compared number
beside its limit; standard output ends with one JSON line: ``correct``,
``attempted`` (the calls of the window), ``failed``, ``metrics``,
``device``, ``entries_per_call``, with ``--trace 1`` ``breakdown``, and last
``checks``. ``--control 1`` puts the control, the plain reference computed
in the precision below the configuration's, in the program's place for the
comparison: its numbers are the upper readings that the limits in
``benchmark/limits`` are set from, and the benchmark's own runs leave it
at 0. Without a card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded, the run prints
no result and exits with a code other than 0.

The port's kernels are built into ``sparsebase_tpu_torch/_build/`` inside
the checkout; the caches of torch's extensions, Triton and CUDA go under
``.bench_cache/`` there, at fixed paths.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = time.perf_counter() - _process_age_s()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def _environment() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))

    import json

    import torch

    from benchmark.core import harness
    from benchmark.core.spec import Spec

    torch.set_num_threads(2)
    spec = Spec(ROOT)
    spec.validate()
    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return EXIT_NO_CARD
    try:
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), process_start=PROCESS_START,
                           spec=spec, control=bool(args.control))
    except harness.ForbiddenModules as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return EXIT_FORBIDDEN
    print(f"benchmark: {args.workload} seed {args.seed}: {line['attempted']} calls of {line['entries_per_call']} "
          f"entries; correct {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
