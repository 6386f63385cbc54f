"""MatrixMarket (.mtx) reader and writer.

Counterpart of ``sparsebase_tpu/io/mtx.py`` (reference:
src/sparsebase/io/mtx_reader.{h,cc}: header parse :29-120, coordinate read
:380-496, array read :124-166; mtx_writer.{h,cc}). The same header options,
fields (``pattern``, ``real``, ``double``, ``integer``, ``complex``: the
real part by default, both parts with a complex ``value_dtype``),
symmetries (``general``, ``symmetric``, ``skew-symmetric``; ``hermitian``
refused), the ``array`` format, ``convert_to_zero_index`` and the
``upper_triangle`` fold.

The body is parsed on the host (numpy's ``loadtxt`` here, fastio in
:mod:`.pigo`). What follows the parse runs as torch ops on the reader's
device (CUDA unless the caller passes ``device="cpu"``): the ids, narrowed
on the host to ``index_dtype_for(max(nrows, ncols))`` so that the copy moves
half the bytes, are shifted to zero-based, folded or mirrored, checked
against the shape, and sorted row-major by ``COO.new`` (kernel K5 on the
card). A file out of its own shape raises ``ReaderError``, since the card's
sort plans its digits from the shape.

The writer writes the bytes the JAX writer writes: ``repr`` of each value
as a double (``float(v)``), ``int(v)`` for the integer field, and only the
lower triangle of a symmetric matrix. It formats the body in blocks, in
C++ (``fastio.format_mtx``) where that library is built, else in Python.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.array import DenseArray
from ..formats.coo import COO
from ..formats.csr import CSR
from ..utils.exceptions import ReaderError, WriterError
from ..utils.typing import index_dtype_for
from .placement import DEFAULT_DEVICE, narrow_ids, target_device

_FIELDS = ("real", "double", "complex", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")
_BLOCK = 1 << 20  # body lines formatted per block by the writer


@dataclasses.dataclass
class _MTXOptions:
    object: str
    format: str
    field: str
    symmetry: str


def _parse_header(line: str) -> _MTXOptions:
    """Parse ``%%MatrixMarket object format field symmetry``
    (mtx_reader.cc:29-120 parity, same rejections)."""
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise ReaderError(f"Invalid MatrixMarket header: {line.strip()!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:5])
    if obj == "vector":
        raise ReaderError("Library does not support reading vectors from MTX files")
    if obj != "matrix":
        raise ReaderError(f"Unknown MTX object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise ReaderError(f"Unknown MTX format {fmt!r}")
    if field not in _FIELDS:
        raise ReaderError(f"Unknown MTX field {field!r}")
    if symmetry == "hermitian":
        raise ReaderError("Library does not support hermitian MTX files")
    if symmetry not in _SYMMETRIES:
        raise ReaderError(f"Unknown MTX symmetry {symmetry!r}")
    return _MTXOptions(obj, fmt, field, symmetry)


def _value_dtype(field: str, requested) -> torch.dtype:
    if requested is not None:
        return requested
    return torch.int64 if field == "integer" else torch.float32


def _combine_complex(re: torch.Tensor, im: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Complex-field values: complex when a complex dtype is requested,
    else the real part."""
    if dtype.is_complex:
        return torch.complex(re, im).to(dtype)
    return re.to(dtype)


def _host(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _assemble_coo(row: torch.Tensor, col: torch.Tensor, vals: Optional[torch.Tensor], shape, symmetry: str,
                 zero_index: bool, upper_triangle: bool, device: torch.device,
                 stable_payload: bool = True) -> COO:
    """The steps after the parse, on ``device``: 1-based ids (already in
    their narrow type) are copied there with the values, shifted to
    zero-based, folded to (min, max) (``upper_triangle``, no expansion,
    mtx_reader.cc:380-403) or mirrored (symmetric: off-diagonal entries;
    skew-symmetric: every entry, negated; mtx_reader.cc:430-486), checked
    against ``shape`` and sorted row-major by ``COO.new``. With
    ``zero_index`` False the ids go back to 1-based after the sort."""
    row, col = row.to(device) - 1, col.to(device) - 1  # ids >= 1: no wrap in the narrow type
    vals = None if vals is None else vals.to(device)
    if upper_triangle:
        row, col = torch.minimum(row, col), torch.maximum(row, col)
    elif symmetry in ("symmetric", "skew-symmetric"):
        keep = row != col if symmetry == "symmetric" else torch.ones_like(row, dtype=torch.bool)
        row, col = torch.cat([row, col[keep]]), torch.cat([col, row[keep]])
        if vals is not None:
            vals = torch.cat([vals, -vals[keep] if symmetry == "skew-symmetric" else vals[keep]])
    nrows, ncols = shape
    if row.numel():
        lo_r, hi_r, lo_c, hi_c = torch.stack([row.min(), row.max(), col.min(), col.max()]).tolist()
        if lo_r < 0 or lo_c < 0 or hi_r >= nrows or hi_c >= ncols:
            raise ReaderError(f"MTX entries reach rows {lo_r + 1}..{hi_r + 1} and columns {lo_c + 1}..{hi_c + 1} "
                              f"outside the size line's {nrows} x {ncols}")
    coo = COO.new(row, col, vals, shape=(nrows, ncols), stable_payload=stable_payload)
    if not zero_index:
        coo = dataclasses.replace(coo, row=coo.row + 1, col=coo.col + 1)
    return coo


class MTXReader:
    """Reads .mtx files into COO/CSR/DenseArray on ``device``.

    Parity: ``io::MTXReader`` (mtx_reader.h:14-60). A pattern file gives
    ``vals=None``. ``id_dtype`` and ``value_dtype`` are torch dtypes."""

    def __init__(self, filename: str, convert_to_zero_index: bool = True, upper_triangle: bool = False,
                 id_dtype=None, value_dtype=None, device=DEFAULT_DEVICE):
        self.filename = filename
        self.convert_to_zero_index = convert_to_zero_index
        self.upper_triangle = upper_triangle
        self.id_dtype = id_dtype
        self.value_dtype = value_dtype
        self.device = target_device(device)
        with open(filename, "r") as f:
            self.options = _parse_header(f.readline())

    # -- internals -----------------------------------------------------------
    def _read_numeric(self) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(body as a float64 2-D array, size-line tuple)."""
        with open(self.filename, "r") as f:
            f.readline()  # header
            skip = 1
            for line in f:
                skip += 1
                s = line.strip()
                if s and not s.startswith("%"):
                    size = tuple(int(x) for x in s.split())
                    break
            else:
                raise ReaderError("MTX file has no size line")
        body = np.loadtxt(self.filename, comments="%", skiprows=skip, dtype=np.float64, ndmin=2)
        if body.size == 0:
            body = body.reshape(0, 3 if self.options.format == "coordinate" else 1)
        return body, size

    def _id_dtype(self, nrows: int, ncols: int) -> torch.dtype:
        return self.id_dtype or index_dtype_for(max(nrows, ncols))

    def _assemble(self, row, col, vals, shape, stable_payload: bool = True) -> COO:
        return _assemble_coo(row, col, vals, shape, self.options.symmetry, self.convert_to_zero_index,
                            self.upper_triangle, self.device, stable_payload)

    def read_coo(self) -> COO:
        opts = self.options
        if opts.format == "array":
            return self._read_array_into_coo()
        body, size = self._read_numeric()
        if len(size) != 3:
            raise ReaderError(f"Coordinate MTX needs 3 sizes, got {size}")
        nrows, ncols, nnz = size
        if body.shape[0] != nnz:
            raise ReaderError(f"Expected {nnz} entries, found {body.shape[0]}")
        weighted = opts.field != "pattern"
        if weighted and body.shape[1] < 3:
            raise ReaderError("Weighted MTX file lacks a value column")
        if opts.field == "complex" and body.shape[1] < 4:
            raise ReaderError("Complex MTX file lacks an imaginary column")
        id_dtype = self._id_dtype(nrows, ncols)
        row, col = narrow_ids(_host(body[:, 0]), id_dtype), narrow_ids(_host(body[:, 1]), id_dtype)
        dtype = _value_dtype(opts.field, self.value_dtype)
        if not weighted:
            vals = None
        elif opts.field == "complex":
            vals = _combine_complex(_host(body[:, 2]), _host(body[:, 3]), dtype)
        else:
            vals = _host(body[:, 2]).to(dtype)
        return self._assemble(row, col, vals, (nrows, ncols))

    def _read_array_into_coo(self) -> COO:
        """Dense 'array' body → COO of its nonzeros (mtx_reader.cc:124-166:
        keeps only w != 0), found on the reader's device."""
        if self.options.field == "pattern":
            raise ReaderError("Array-format MTX cannot be pattern")
        if self.options.symmetry != "general":
            raise ReaderError(
                "Library does not support reading array files that are symmetric, skew-symmetric, or hermitian"
            )
        body, size = self._read_numeric()
        if len(size) != 2:
            raise ReaderError(f"Array MTX needs 2 sizes, got {size}")
        nrows, ncols = size
        flat = self._array_body_values(body, nrows * ncols).to(self.device)
        idx = torch.nonzero(flat != 0).flatten()  # column-major positions
        id_dtype = self._id_dtype(nrows, ncols)
        coo = COO.new((idx % nrows).to(id_dtype), (idx // nrows).to(id_dtype), flat[idx], shape=(nrows, ncols))
        return coo

    def _array_body_values(self, body: np.ndarray, expected: Optional[int]) -> torch.Tensor:
        """The array-format body as a value vector on the host, combining the
        two-column complex body (re, im per line) when field == complex."""
        dtype = _value_dtype(self.options.field, self.value_dtype)
        if self.options.field == "complex":
            flat = body.reshape(-1)
            if flat.shape[0] % 2 != 0:
                raise ReaderError("Complex array MTX body has an odd token count")
            pairs = flat.reshape(-1, 2)
            vals = _combine_complex(_host(pairs[:, 0]), _host(pairs[:, 1]), dtype)
        else:
            vals = _host(body.reshape(-1)).to(dtype)
        if expected is not None and vals.shape[0] != expected:
            raise ReaderError(f"Expected {expected} values, found {vals.shape[0]}")
        return vals

    def read_csr(self) -> CSR:
        """ReadCOO + conversion (mtx_reader.cc:573-579 parity)."""
        from ..convert.kernels import coo_to_csr

        return coo_to_csr(self.read_coo())

    def read_array(self) -> DenseArray:
        """An array-format file (or a coordinate one, densified) as a dense
        1-D array (mtx_reader.cc ReadArrayIntoArray)."""
        if self.options.field == "pattern":
            raise ReaderError("Cannot read a pattern MTX into a value array")
        if self.options.format == "array":
            body, size = self._read_numeric()
            expected = int(np.prod(size)) if len(size) == 2 else None
            return DenseArray(self._array_body_values(body, expected).to(self.device))
        dense = self.read_coo().to_dense().reshape(-1)
        return DenseArray(dense.to(_value_dtype(self.options.field, self.value_dtype)))


class MTXWriter:
    """Writes COO/CSR/DenseArray to .mtx, from any device.

    Parity: ``io::MTXWriter`` (mtx_writer.h:16-40) with its header options;
    symmetric output keeps only the lower triangle."""

    def __init__(self, filename: str, object: str = "matrix", format: str = "coordinate", field: str = "real",
                 symmetry: str = "general"):
        self.filename = filename
        if object not in ("matrix",):
            raise WriterError(f"Unsupported MTX object {object!r}")
        if format not in ("coordinate", "array"):
            raise WriterError(f"Unsupported MTX format {format!r}")
        if field not in _FIELDS:
            raise WriterError(f"Unknown MTX field {field!r}")
        if symmetry == "hermitian":
            raise WriterError("Hermitian MTX writing is not supported")
        if symmetry not in _SYMMETRIES:
            raise WriterError(f"Unknown MTX symmetry {symmetry!r}")
        self.object = object
        self.format = format
        self.field = field
        self.symmetry = symmetry

    def _header(self) -> str:
        return f"%%MatrixMarket {self.object} {self.format} {self.field} {self.symmetry}\n"

    def _fmt_val(self, v) -> str:
        if self.field == "integer":
            return str(int(v))
        if self.field == "complex":
            c = complex(v)
            return f"{c.real!r} {c.imag!r}"
        return repr(float(v))

    def _native_values(self, vals: Optional[torch.Tensor]):
        """``(ivals, dvals)`` for ``fastio.format_mtx``, or None where the
        values need Python's own conversion: complex values, or integer
        output of floats that are not finite or pass int64 (``int(v)``
        raises or grows there)."""
        from ..config import get_config
        from . import fastio

        if not (get_config().use_fastio and fastio.available()):
            return None
        if vals is None:
            return None, None
        if vals.dtype.is_complex or self.field == "complex":
            return None
        if self.field != "integer":
            return None, vals.to(torch.float64)
        if vals.dtype.is_floating_point and vals.numel():
            if not bool(torch.isfinite(vals).all()) or float(vals.double().abs().max()) >= 2.0 ** 63:
                return None
        return vals.to(torch.int64), None

    def _write_body(self, f, row: Optional[torch.Tensor], col: Optional[torch.Tensor],
                    vals: Optional[torch.Tensor]) -> None:
        """Body lines ``r+1 c+1[ v]`` (``row`` None: ``v`` alone), in blocks
        of ``_BLOCK`` lines."""
        from . import fastio

        n = len(vals) if row is None else len(row)
        native = self._native_values(vals)
        if native is not None:
            ivals, dvals = native
            row = None if row is None else row.to(torch.int64)
            col = None if col is None else col.to(torch.int64)
            buf = np.empty(min(n, _BLOCK) * fastio.LINE_BYTES, dtype=np.uint8)
            for lo in range(0, n, _BLOCK):
                hi = min(lo + _BLOCK, n)

                def cut(t):
                    return None if t is None else t[lo:hi]

                f.write(fastio.format_mtx(cut(row), cut(col), 1, ivals=cut(ivals), dvals=cut(dvals), buf=buf))
            return
        if vals is not None and vals.dtype == torch.bfloat16:
            vals = vals.to(torch.float32)  # exact; numpy has no bfloat16
        vals_np = None if vals is None else vals.numpy()
        for lo in range(0, n, _BLOCK):
            hi = min(lo + _BLOCK, n)
            vs = None if vals_np is None else [self._fmt_val(v) for v in vals_np[lo:hi]]
            if row is None:
                lines = [v + "\n" for v in vs]
            elif vs is None:
                lines = [f"{r + 1} {c + 1}\n" for r, c in zip(row[lo:hi].tolist(), col[lo:hi].tolist())]
            else:
                lines = [f"{r + 1} {c + 1} {v}\n" for r, c, v in zip(row[lo:hi].tolist(), col[lo:hi].tolist(), vs)]
            f.write("".join(lines).encode())

    def write_coo(self, coo: COO) -> None:
        coo = coo.to_host()
        row, col, vals = coo.row, coo.col, coo.vals
        if self.field == "pattern":
            vals = None
        elif vals is None:
            raise WriterError("Cannot write pattern matrix with a value field; use field='pattern'")
        if self.format == "array":
            with open(self.filename, "wb") as f:
                f.write(self._header().encode())
                f.write(f"{coo.nrows} {coo.ncols}\n".encode())
                self._write_body(f, None, None, coo.to_dense().T.reshape(-1).contiguous())  # column-major
            return
        if self.symmetry in ("symmetric", "skew-symmetric"):
            keep = row >= col  # store the lower triangle
            row, col = row[keep], col[keep]
            if vals is not None:
                vals = vals[keep]
        with open(self.filename, "wb") as f:
            f.write(self._header().encode())
            f.write(f"{coo.nrows} {coo.ncols} {row.shape[0]}\n".encode())
            self._write_body(f, row, col, vals)

    def write_csr(self, csr: CSR) -> None:
        from ..convert.kernels import csr_to_coo

        self.write_coo(csr_to_coo(csr.to_host()))

    def write_array(self, arr: DenseArray) -> None:
        if self.field == "pattern":
            raise WriterError("Cannot write a value array as pattern")
        vals = arr.to_host().vals
        with open(self.filename, "wb") as f:
            f.write(f"%%MatrixMarket matrix array {self.field} general\n".encode())
            f.write(f"{vals.shape[0]} 1\n".encode())
            self._write_body(f, None, None, vals.contiguous())
