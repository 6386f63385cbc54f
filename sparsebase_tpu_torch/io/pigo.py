"""PIGO-equivalent parallel readers: the native mmap + OpenMP parse.

Counterpart of ``sparsebase_tpu/io/pigo.py`` (reference:
``io::PigoMTXReader`` / ``io::PigoEdgeListReader``,
src/sparsebase/io/pigo_mtx_reader.cc, pigo_edge_list_reader.cc). The same
semantics as the plain readers; only the body parse changes, to fastio
(``io/fastio``). Without the native library, or with
``config.use_fastio`` off, they take the plain readers' numpy parse.
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import ReaderError
from . import fastio
from .edge_list import EdgeListReader
from .mtx import MTXReader, _value_dtype
from .placement import narrow_ids


def _body_offset(filename: str) -> tuple[int, tuple]:
    """Byte offset of the first data line, and the parsed size line."""
    offset = 0
    size = None
    with open(filename, "rb") as f:
        first = True
        for raw in f:
            offset += len(raw)
            line = raw.decode("ascii", "replace").strip()
            if first:
                first = False
                continue  # header
            if not line or line.startswith("%"):
                continue
            size = tuple(int(float(t)) for t in line.split())
            break
    if size is None:
        raise ReaderError("MTX file has no size line")
    return offset, size


def _fastio_enabled() -> bool:
    from ..config import get_config

    return get_config().use_fastio and fastio.available()


class PigoMTXReader(MTXReader):
    """MTXReader with the native parallel body parse."""

    def parse(self):
        """The host half of :meth:`read_coo` on a coordinate body: the
        entries as fastio parses them, the ids narrowed to their index type
        and the values cast to their type, still on the host:
        ``(row, col, vals, (nrows, ncols))``."""
        opts = self.options
        offset, size = _body_offset(self.filename)
        if len(size) != 3:
            raise ReaderError(f"Coordinate MTX needs 3 sizes, got {size}")
        nrows, ncols, nnz = size
        weighted = opts.field != "pattern"
        row64, col64, vals = fastio.parse_entries(self.filename, offset, weighted)
        if len(row64) != nnz:
            raise ReaderError(f"Expected {nnz} entries, found {len(row64)}")
        id_dtype = self._id_dtype(nrows, ncols)
        vals = vals.to(_value_dtype(opts.field, self.value_dtype)) if weighted else None
        return narrow_ids(row64, id_dtype), narrow_ids(col64, id_dtype), vals, (nrows, ncols)

    def read_coo(self):
        """Coordinate bodies go straight from fastio's int64 ids to the COO,
        with no float64 body in between (``sparsebase_tpu/io/pigo.py:51-109``);
        the order among the payloads of duplicate coordinates is left open,
        as the JAX reader leaves it."""
        opts = self.options
        if not _fastio_enabled() or opts.format != "coordinate" or opts.field == "complex":
            return super().read_coo()
        row, col, vals, shape = self.parse()
        return self._assemble(row, col, vals, shape, stable_payload=False)

    def _read_numeric(self):
        # complex bodies have 4 (coordinate) or 2 (array) value tokens per
        # line; the native parser reads the 2- and 3-column layouts only
        if not _fastio_enabled() or self.options.field == "complex":
            return super()._read_numeric()
        offset, size = _body_offset(self.filename)
        if self.options.format == "array":
            return fastio.parse_values(self.filename, offset).numpy().reshape(-1, 1), size
        weighted = self.options.field != "pattern"
        rows, cols, vals = fastio.parse_entries(self.filename, offset, weighted)
        cols_f = [rows.numpy().astype(np.float64), cols.numpy().astype(np.float64)]
        return np.column_stack(cols_f + ([vals.numpy()] if weighted else [])), size


class PigoEdgeListReader(EdgeListReader):
    """EdgeListReader with the native parallel body parse."""

    def _load_body(self) -> np.ndarray:
        if not _fastio_enabled():
            return super()._load_body()
        try:
            rows, cols, vals = fastio.parse_entries(self.filename, 0, self.weighted)
        except OSError as e:
            raise ReaderError(str(e))
        cols_f = [rows.numpy().astype(np.float64), cols.numpy().astype(np.float64)]
        return np.column_stack(cols_f + ([vals.numpy()] if self.weighted else []))
