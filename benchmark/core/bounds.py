"""The least time the card could take for a kernel's work, from shapes.

A frozen copy of the arithmetic of ``chip_smoke.py`` (``bound_bytes``,
``bound_ops``, ``bound``): each input read once and each output written
once (float32 values and vectors, int32 ids, int64 offsets), whatever the
kernel reads again, over the published peaks of one NVIDIA H100 SXM. The
counts are those of the work, not of an implementation, so they hold
whatever implements the kernel.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, data sheet (700 W)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, data sheet (700 W)


def bound_bytes(kernel: str, **s) -> int:
    """Bytes the kernel's function must move at the given shapes.

    banded_spmv: ndiag, n, m, band_bytes; csr_spmv: n, ncols, nnz, pattern;
    indptr: nnz, nrows; relocate_csr: n, nnz, order_entries (entries of the
    distinct order tensors), value_bytes; radix_rank: n, key_bytes,
    sorted_keys; label_prop: n, nnz."""
    if kernel == "banded_spmv":  # band, offsets, x in; y out
        return s["ndiag"] * s["n"] * s["band_bytes"] + 4 * s["ndiag"] + 4 * s["m"] + 4 * s["n"]
    if kernel == "csr_spmv":  # indptr, ids, values, x in; y out
        values = 0 if s.get("pattern") else 4 * s["nnz"]
        return 8 * (s["n"] + 1) + 4 * s["nnz"] + values + 4 * s["ncols"] + 4 * s["n"]
    if kernel == "indptr":  # row ids in; indptr out
        return 4 * s["nnz"] + 8 * (s["nrows"] + 1)
    if kernel == "relocate_csr":  # indptr, ids, values, orders in; indptr, ids, values out
        csr = 8 * (s["n"] + 1) + (4 + s["value_bytes"]) * s["nnz"]
        return 2 * csr + 4 * s["order_entries"]
    if kernel == "radix_rank":  # keys in; int32 ranks out, and the sorted keys on request
        return s["n"] * (s["key_bytes"] + 4 + (s["key_bytes"] if s.get("sorted_keys") else 0))
    if kernel == "label_prop":  # indptr, ids, labels in; labels out
        return 8 * (s["n"] + 1) + 4 * s["nnz"] + 4 * s["n"] + 4 * s["n"]
    raise KeyError(kernel)


def bound_ops(kernel: str, **s) -> int:
    """Floating-point operations of the kernel's function: a multiply and an
    add per stored entry of the SpMVs; label_prop an add per entry into the
    counts and a subtraction per cell for the scores (k parts, 8 unless
    given). The integer kernels do none."""
    if kernel == "banded_spmv":
        return 2 * s["ndiag"] * s["n"]
    if kernel == "csr_spmv":
        return 2 * s["nnz"]
    if kernel == "label_prop":
        return s["nnz"] + s["n"] * s.get("k", 8)
    return 0


def bound(kernel: str, **s) -> Tuple[float, str]:
    """``(seconds, "bytes" or "operations")``: the least time the card could
    take, and which of the two peaks sets it."""
    by_bytes = bound_bytes(kernel, **s) / HBM_BYTES_PER_S
    by_ops = bound_ops(kernel, **s) / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def roofline_pct(kernel: str, seconds: float, **s):
    """The share (%) of the bound in ``seconds`` of device time; None where
    no time was read, so that a reader never reports a share of 0."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound(kernel, **s)[0] / seconds
