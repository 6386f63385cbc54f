#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``sparsebase_tpu_torch``) on one card.

    python3 chip_smoke.py [--nnz 100e6] [--band-nnz 64e6] [--seed 0]

Phases, in order; any failure raises and the script exits non-zero:

0. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit (``nvidia-smi``);
1. builds the kernels from ``sparsebase_tpu_torch/csrc`` (nvcc, sm_90a);
2. kernel vs plain version on the card, at edge shapes: K1 (DIA SpMV; f32
   and bf16 band, strided and tiled layout, a rectangular band) and K2
   (CSR SpMV; empty rows, a pattern matrix, one row of 262,144 entries);
3. the main path, once, with every launch count set to 0 just before:
   path A, ``preprocess_pipeline`` on a ``--nnz`` COO made on the device
   (uniform rows, columns 20% from [0, n/100), row-major sorted, duplicates
   kept; n = nnz/16); path B, a banded COO (33 diagonals, ``--band-nnz``
   stored entries) through ``convert(CSR)``, ``convert(DIA)`` and
   ``spmv(dia, x)``. Both kernels must have launched;
4. checks of path A (indptr, per-row column order, degree order, ``y``
   against the plain SpMV of the permuted matrix) and of path B (K1 against
   K2 and against its plain version);
5. times: path A end to end (median of 5 after one warm-up), and each
   kernel beside its plain version at the main path's shapes.

The agreement of a kernel with its plain version is held per row to
``|y_k - y_p| <= 4 * deg_i * eps_f32 * (|A| |x|)_i``, which bounds two f32
sums of the same terms taken in different orders.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

EPS_F32 = torch.finfo(torch.float32).eps
WIDE_OFFSETS = (-150, -7, 0, 2, 133)
BAND_HALF_WIDTH = 16  # 33 diagonals


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def check_rows(name: str, y, y_ref, deg, absdot) -> float:
    """Per-row agreement within the reordered-f32-sum bound; returns the
    largest absolute difference."""
    err = (y.to(torch.float32) - y_ref.to(torch.float32)).abs()
    bound = 4.0 * deg.to(torch.float32) * EPS_F32 * absdot.to(torch.float32)
    over = int((err > bound).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"  {name}: rows={y.numel()} max_abs_err={max_err:.6g} rows_over_bound={over}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    check(over == 0, f"{name}: {over} rows disagree beyond the bound")
    return max_err


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn`` in ms, synchronised, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- inputs, made on the device from a seed ----------------------------------
def dia_case(g, dev, n, m, offsets, dtype):
    from sparsebase_tpu_torch import DIA

    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    data = torch.randn((len(offsets), n), generator=g, device=dev).to(dtype)
    x = torch.randn((m,), generator=g, device=dev)
    return DIA(offs, data, (n, m)), x


def dia_row_degrees(dia):
    n, m = dia.shape
    i = torch.arange(n, device=dia.data.device)
    j = i[None, :] + dia.offsets.to(torch.int64)[:, None]
    return ((j >= 0) & (j < m)).sum(dim=0)


def csr_case(g, dev, degrees, ncols, pattern=False):
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.convert.kernels import indptr_from_counts

    degrees = degrees.to(dev)
    indptr = indptr_from_counts(degrees)
    nnz = int(indptr[-1])
    cols = torch.randint(0, ncols, (nnz,), generator=g, device=dev, dtype=torch.int32)
    vals = None if pattern else torch.randn((nnz,), generator=g, device=dev)
    csr = CSR(indptr, cols, vals, (degrees.numel(), ncols)).sort_rows()
    x = torch.randn((ncols,), generator=g, device=dev)
    return csr, x


def power_law_coo(g, dev, n, nnz):
    """Rows uniform, columns 20% from a clump [0, n/100), row-major sorted,
    duplicates kept (the benchmark graph of bench.py)."""
    from sparsebase_tpu_torch import COO
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs

    row = torch.randint(0, n, (nnz,), generator=g, device=dev, dtype=torch.int32)
    clump = torch.randint(0, max(n // 100, 1), (nnz,), generator=g, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=g, device=dev, dtype=torch.int32)
    col = torch.where(torch.rand((nnz,), generator=g, device=dev) < 0.2, clump, col)
    del clump
    vals = torch.randn((nnz,), generator=g, device=dev)
    row, col, vals = sort_by_pairs(row, col, vals)
    return COO(row, col, vals, (n, n))


def banded_coo(g, dev, band_nnz):
    """A square matrix with every entry of diagonals -16..16 stored."""
    from sparsebase_tpu_torch import COO

    k = 2 * BAND_HALF_WIDTH + 1
    n = band_nnz // k
    offs = torch.arange(-BAND_HALF_WIDTH, BAND_HALF_WIDTH + 1, device=dev)
    i = torch.arange(n, device=dev)[:, None]
    j = i + offs[None, :]
    ok = (j >= 0) & (j < n)
    row = i.expand_as(j)[ok].to(torch.int32)  # row-major walk: already sorted
    col = j[ok].to(torch.int32)
    del i, j, ok
    vals = torch.randn((row.numel(),), generator=g, device=dev)
    return COO(row, col, vals, (n, n))


def abs_csr(csr):
    from sparsebase_tpu_torch import CSR

    return CSR(csr.indptr, csr.indices, None if csr.vals is None else csr.vals.abs(), csr.shape)


# -- phases ------------------------------------------------------------------
def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0)


def phase_build() -> None:
    from sparsebase_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1 build and load: {time.perf_counter() - t0:.2f} s -> {_build.build()}")


def phase_kernels_vs_plain(g, dev) -> None:
    from sparsebase_tpu_torch.ops.kernels import banded_spmv, csr_spmv, csr_spmv_plain, dia_spmv_plain

    print("phase 2 kernels vs plain")
    n = 1_000_003
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("strided", "tiled"):
            dia, x = dia_case(g, dev, n, n, WIDE_OFFSETS, dtype)
            y = banded_spmv(dia, x, layout=layout)
            torch.cuda.synchronize()
            y_p = dia_spmv_plain(dia.offsets, dia.data, x, dia.shape)
            absdot = dia_spmv_plain(dia.offsets, dia.data.abs(), x.abs(), dia.shape)
            check_rows(f"K1 {str(dtype)[6:]} {layout} n={n}", y, y_p, dia_row_degrees(dia), absdot)
    dia, x = dia_case(g, dev, n, n - 997, WIDE_OFFSETS, torch.float32)
    y = banded_spmv(dia, x)
    torch.cuda.synchronize()
    absdot = dia_spmv_plain(dia.offsets, dia.data.abs(), x.abs(), dia.shape)
    check_rows(f"K1 f32 rectangular {dia.shape}", y, dia_spmv_plain(dia.offsets, dia.data, x, dia.shape),
               dia_row_degrees(dia), absdot)

    rows = 100_000
    deg = torch.randint(0, 40, (rows,), generator=g, device=dev)
    deg[::7] = 0  # empty rows
    long_row = deg.clone()
    long_row[rows // 2] = 262_144
    for name, degrees, pattern in (
        ("empty rows", deg, False),
        ("pattern", deg, True),
        ("one row of 262144", long_row, False),
    ):
        csr, x = csr_case(g, dev, degrees, 50_000, pattern)
        y = csr_spmv(csr, x)
        torch.cuda.synchronize()
        absdot = csr_spmv_plain(abs_csr(csr), x.abs())
        check_rows(f"K2 {name}", y, csr_spmv_plain(csr, x), csr.degrees(), absdot)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nnz", type=float, default=100e6, help="path A entries (default 100M)")
    ap.add_argument("--band-nnz", type=float, default=64e6, help="path B stored band entries (default 64M)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = phase_device()
    import sparsebase_tpu_torch as sbt
    from sparsebase_tpu_torch import CSR, DIA, _build
    from sparsebase_tpu_torch.ops.kernels import banded_spmv, csr_spmv, csr_spmv_plain, dia_spmv_plain
    from sparsebase_tpu_torch.ops.reorder import DegreeReorder

    phase_build()
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    phase_kernels_vs_plain(g, dev)

    # -- the main path, once ------------------------------------------------------
    nnz = int(args.nnz)
    n = max(nnz // 16, 1)
    coo_a = power_law_coo(g, dev, n, nnz)
    x_a = torch.randn((n,), generator=g, device=dev)
    coo_b = banded_coo(g, dev, int(args.band_nnz))
    x_b = torch.randn((coo_b.ncols,), generator=g, device=dev)
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    permuted, y_a = sbt.preprocess_pipeline(coo_a, x_a)
    csr_b = coo_b.convert(CSR)
    dia_b = csr_b.convert(DIA)
    y_b = sbt.spmv(dia_b, x_b)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    print(f"phase 3 main path: launches {launches}")
    check(launches["csr_spmv"] > 0, "path A did not launch K2 (csr_spmv)")
    check(launches["banded_spmv"] > 0, "path B did not launch K1 (banded_spmv)")

    # -- checks ---------------------------------------------------------------------
    print(f"phase 4 path A checks: n={n} nnz={nnz}")
    src = CSR(sbt.convert.kernels.indptr_from_sorted_rows(coo_a.row, n), coo_a.col, coo_a.vals, coo_a.shape)
    ip = permuted.indptr
    check(ip.shape == (n + 1,) and int(ip[0]) == 0 and int(ip[-1]) == nnz, "permuted indptr ends")
    check(bool((ip[1:] >= ip[:-1]).all()), "permuted indptr is not monotone")
    check(permuted.is_sorted(), "permuted columns are not sorted within rows")
    check(bool((permuted.degrees()[1:] >= permuted.degrees()[:-1]).all()), "rows are not in ascending degree order")
    ro = DegreeReorder().get_reorder(src)
    check(bool((torch.bincount(ro.long(), minlength=n) == 1).all()), "ro is not a permutation")
    x_new = torch.empty_like(x_a)
    x_new[ro] = x_a
    check_rows("path A y vs plain SpMV of the permuted matrix", y_a, csr_spmv_plain(permuted, x_new),
               permuted.degrees(), csr_spmv_plain(abs_csr(permuted), x_new.abs()))

    print(f"phase 4 path B checks: n={coo_b.nrows} band entries={coo_b.nnz} diagonals={dia_b.num_diagonals}")
    check(dia_b.num_diagonals == 2 * BAND_HALF_WIDTH + 1, "DIA has the wrong number of diagonals")
    absdot_b = dia_spmv_plain(dia_b.offsets, dia_b.data.abs(), x_b.abs(), dia_b.shape)
    deg_b = dia_row_degrees(dia_b)
    y_b_csr = sbt.spmv(csr_b, x_b)
    check_rows("path B K1 vs K2", y_b, y_b_csr, deg_b, absdot_b)
    err_k1 = check_rows("path B K1 vs plain", y_b, dia_spmv_plain(dia_b.offsets, dia_b.data, x_b, dia_b.shape),
                        deg_b, absdot_b)
    err_k2 = check_rows("path A K2 vs plain (source CSR)", csr_spmv(src, x_a), csr_spmv_plain(src, x_a),
                        src.degrees(), csr_spmv_plain(abs_csr(src), x_a.abs()))

    # -- times ----------------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    ms_a = host_ms(lambda: sbt.preprocess_pipeline(coo_a, x_a))
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5 path A preprocess_pipeline: median {ms_a:.3f} ms, {nnz / (ms_a / 1e3):.4g} nnz/s, "
          f"peak device memory {peak / 2**30:.3f} GiB (inputs included)")
    k2_ms = cuda_ms(lambda: csr_spmv(src, x_a))
    k2_plain_ms = cuda_ms(lambda: csr_spmv_plain(src, x_a))
    print(f"phase 5 path A K2 csr_spmv: {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")
    k1_ms = cuda_ms(lambda: banded_spmv(dia_b, x_b))
    k1_plain_ms = cuda_ms(lambda: dia_spmv_plain(dia_b.offsets, dia_b.data, x_b, dia_b.shape))
    b_csr_ms = cuda_ms(lambda: csr_spmv(csr_b, x_b))
    print(f"phase 5 path B spmv: DIA (K1) {k1_ms:.4f} ms, CSR (K2) {b_csr_ms:.4f} ms, "
          f"K1 plain {k1_plain_ms:.4f} ms")

    record = {"kernels": [
        {"name": "banded_spmv", "route": "cuda", "source": "sparsebase_tpu_torch/csrc/banded_spmv.cu",
         "replaces": "sparsebase_tpu/ops/kernels/banded_spmv.py:67", "launches": launches["banded_spmv"],
         "max_abs_err": err_k1, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "csr_spmv", "route": "cuda", "source": "sparsebase_tpu_torch/csrc/csr_spmv.cu",
         "replaces": "sparsebase_tpu/models/pipelines.py:189", "launches": launches["csr_spmv"],
         "max_abs_err": err_k2, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
