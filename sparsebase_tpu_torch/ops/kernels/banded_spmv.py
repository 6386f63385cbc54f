"""DIA (banded) SpMV: the wrapper over kernel K1 and its plain version.

Counterpart of ``sparsebase_tpu/ops/kernels/banded_spmv.py``: the Pallas
kernels ``_kernel`` / ``_kernel_tiled`` become one hand-written CUDA
kernel (``csrc/banded_spmv.cu``) with two band layouts, and
``dia_spmv_reference`` becomes :func:`dia_spmv_plain`.

    y[i] = Σ_d  data[d, i] * x[i + offsets[d]]     (terms with j ∉ [0, m) skipped)

CPU tensors take the plain version. CUDA tensors launch the kernel, or
the wrapper raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..._build import Kernel
from ...formats.dia import DIA
from ...utils.exceptions import TypeMismatchError

TILE = 4096  # tile width of the "tiled" band layout (the reference kernel's block)
LAYOUTS = ("strided", "tiled")

_K1 = Kernel(
    "banded_spmv",
    "sb_dia_spmv",
    [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p],
)


def tile_band(data: torch.Tensor, block: int = TILE) -> torch.Tensor:
    """(k, n) band → (nb, k, block) tiles, the last tile zero-padded: each
    row block's band is one contiguous run."""
    k, n = data.shape
    nb = -(-n // block)
    padded = F.pad(data, (0, nb * block - n))
    return padded.reshape(k, nb, block).permute(1, 0, 2).contiguous()


def untile_band(tiles: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`tile_band`."""
    nb, k, block = tiles.shape
    return tiles.permute(1, 0, 2).reshape(k, nb * block)[:, :n]


def dia_spmv_plain(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor, shape) -> torch.Tensor:
    """Masked shift-and-add over a (k, n) band, in f32 (mirrors
    ``dia_spmv_reference``): the correctness oracle of the kernel."""
    n, m = shape
    x = x.to(torch.float32)
    y = torch.zeros((n,), dtype=torch.float32, device=data.device)
    if m == 0:
        return y
    i = torch.arange(n, device=data.device)
    for d, off in enumerate(offsets.tolist()):
        j = i + off
        ok = (j >= 0) & (j < m)
        xv = torch.where(ok, x[j.clamp(0, m - 1)], 0.0)
        y = y + data[d].to(torch.float32) * xv
    return y


def banded_spmv(dia: DIA, x: torch.Tensor, *, layout: str = "strided", block: int = TILE) -> torch.Tensor:
    """y = A @ x for a DIA matrix, as f32.

    A bf16 band stays bf16 (half the bytes read); any other band dtype is
    promoted to f32, as is ``x``. ``layout="tiled"`` first lays the band
    out as (nb, k, block) tiles (:func:`tile_band`) and runs the kernel's
    tiled index."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    n, m = dia.shape
    data = dia.data if dia.data.dtype == torch.bfloat16 else dia.data.to(torch.float32)
    x = x.to(torch.float32)
    if x.shape != (m,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({m},)")
    band = data if layout == "strided" else tile_band(data, block)
    devices = {t.device for t in (dia.offsets, band, x)}
    if devices == {torch.device("cpu")}:
        flat = band if layout == "strided" else untile_band(band, n)
        return dia_spmv_plain(dia.offsets, flat, x, dia.shape)
    return _launch(dia.offsets, band, x, n, m, layout, block, devices)


def _launch(offsets, band, x, n, m, layout, block, devices) -> torch.Tensor:
    if len(devices) != 1 or x.device.type != "cuda":
        raise TypeMismatchError(f"banded_spmv: tensors on {sorted(map(str, devices))}; need one CUDA device")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise TypeMismatchError("banded_spmv: offsets must be a 1-D int32 tensor")
    k = offsets.shape[0]
    expected = (k, n) if layout == "strided" else (-(-n // block), k, block)
    if tuple(band.shape) != expected:
        raise ValueError(f"banded_spmv: band has shape {tuple(band.shape)}, expected {expected}")
    offsets, band, x = offsets.contiguous(), band.contiguous(), x.contiguous()
    y = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _K1.launch(
            offsets.data_ptr(), band.data_ptr(), x.data_ptr(), y.data_ptr(),
            k, n, m, block, int(layout == "tiled"), int(band.dtype == torch.bfloat16),
            stream,
        )
    return y
