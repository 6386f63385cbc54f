"""The numbers that decide ``correct``, and the control outputs.

Each number is worked out from the benchmark's own inputs with the plain
references beside this file; the program's outputs are only read, to be
judged. The control is the reference itself, computed in bfloat16 (the
precision below the configuration's float32), in the program's place: its
outputs have the program's structure and go through the same numbers.
A number that is not finite is written as :data:`NOT_FINITE`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import csr as ref_csr
from . import dia as ref_dia

NOT_FINITE = 1e300


def finite(value: float) -> float:
    return value if math.isfinite(value) else NOT_FINITE


def row_gap(y: torch.Tensor, want: torch.Tensor, absdot: torch.Tensor) -> float:
    """The widest ``|y_i - want_i| / (|A| |x|)_i`` over the rows; a row whose
    ``(|A| |x|)_i`` is 0 must be exactly 0, else it reads infinite."""
    if y.numel() != want.numel():
        return NOT_FINITE
    err = (y.to(torch.float64) - want).abs()
    rel = torch.where(absdot > 0, err / absdot.clamp_min(torch.finfo(torch.float64).tiny),
                      torch.where(err > 0, math.inf, 0.0))
    return finite(float(rel.max())) if rel.numel() else 0.0


def permuted_spmv(inputs, rank: torch.Tensor, dtype: torch.dtype = torch.float64):
    """``(y, |A||x| permuted)`` of the permuted system: ``y[rank[i]] = (A x)[i]``."""
    y_old, absdot = ref_csr.spmv(inputs["row"], inputs["col"], inputs["vals"], inputs["x"], inputs["n"], dtype)
    y, a = torch.empty_like(y_old), torch.empty_like(absdot)
    y[rank], a[rank] = y_old, absdot
    return y, a


def permutation_numbers(got: Dict[str, torch.Tensor], inputs, rank: torch.Tensor, indptr: torch.Tensor) -> Dict[str, float]:
    """``csr_mismatch``: entries of the permuted CSR (offsets, ids, values)
    that differ from ``P A P^T``; ``y_err``: the widest row gap of ``y``
    from ``P A x`` in float64."""
    bad = ref_csr.csr_mismatches(got["indptr"], got["indices"], got["vals"], indptr, inputs["col"], inputs["vals"], rank)
    want, absdot = permuted_spmv(inputs, rank)
    return {"csr_mismatch": float(bad), "y_err": row_gap(got["y"], want, absdot)}


def permuted_control(inputs, rank: torch.Tensor, indptr: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's permuted CSR and ``y``, computed in bfloat16."""
    new_indptr = ref_csr.permuted_indptr(indptr, ref_csr.inverse(rank))
    nnz = int(new_indptr[-1])
    dev = indptr.device
    indices = torch.empty((nnz,), dtype=torch.int32, device=dev)
    vals = torch.empty((nnz,), dtype=torch.float32, device=dev)
    for lo, hi, ncol, nval in ref_csr.permuted_rows(indptr, inputs["col"], inputs["vals"], rank, new_indptr):
        indices[lo:hi] = ncol.to(torch.int32)
        vals[lo:hi] = nval.to(torch.bfloat16).to(torch.float32)
    y, _ = permuted_spmv(inputs, rank, torch.bfloat16)
    return {"indptr": new_indptr, "indices": indices, "vals": vals, "y": y.to(torch.float32)}


def band_numbers(got: Dict[str, torch.Tensor], inputs, iterations: int, scale: float) -> Dict[str, float]:
    """``dia_mismatch``: offsets and band cells that differ from the band of
    the input, bit for bit; ``x_err``: the widest gap of the last iterate
    from the float64 one, over the float64 iterate's largest magnitude."""
    offsets, data = ref_dia.band(inputs["row"], inputs["col"], inputs["vals"], inputs["n"], torch.float32)
    g_off, g_data = got["offsets"].long(), got["data"]
    if g_off.shape != offsets.shape or g_data.shape != data.shape or g_data.dtype != torch.float32:
        bad = float(abs(g_data.numel() - data.numel()) + abs(g_off.numel() - offsets.numel()) + 1)
    else:
        bad = float((g_off != offsets).sum())
        for d in range(offsets.numel()):
            bad += float((g_data[d].view(torch.int32) != data[d].view(torch.int32)).sum())
    want = ref_dia.iterate(offsets, data.to(torch.float64), inputs["x"], iterations, scale)
    if got["x"].numel() != want.numel():
        return {"dia_mismatch": bad, "x_err": NOT_FINITE}
    top = float(want.abs().max())
    gap = float((got["x"].to(torch.float64) - want).abs().max())
    if top == 0:
        return {"dia_mismatch": bad, "x_err": 0.0 if gap == 0 else NOT_FINITE}
    return {"dia_mismatch": bad, "x_err": finite(gap / top)}


def band_control(inputs, iterations: int, scale: float) -> Dict[str, torch.Tensor]:
    """The reference's band and iterate, computed in bfloat16."""
    offsets, data = ref_dia.band(inputs["row"], inputs["col"], inputs["vals"], inputs["n"], torch.bfloat16)
    x = ref_dia.iterate(offsets, data, inputs["x"], iterations, scale)
    return {"offsets": offsets, "data": data.to(torch.float32), "x": x.to(torch.float32)}
