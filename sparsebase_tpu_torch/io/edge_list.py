"""Edge-list reader and writer.

Counterpart of ``sparsebase_tpu/io/edge_list.py`` (reference:
src/sparsebase/io/edge_list_reader.{h,cc}, options :34-40;
edge_list_writer.cc). The body is parsed on the host (numpy's ``loadtxt``;
fastio in :mod:`.pigo`); the self-edge filter, the undirected doubling and
the duplicate filter run as torch ops on the reader's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.coo import COO
from ..formats.csr import CSR
from ..utils.exceptions import ReaderError
from ..utils.typing import index_dtype_for
from .placement import DEFAULT_DEVICE, narrow_ids, target_device


def _first_occurrences(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Positions of the first copy of each (row, col) pair, ascending (what
    ``np.unique(pairs, axis=0, return_index=True)`` and a sort give)."""
    key = (row.to(torch.int64) << 32) | col.to(torch.int64)
    key, order = torch.sort(key, stable=True)
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    return torch.sort(order[head]).values


class EdgeListReader:
    """Reads text edge lists, ``u v [w]`` per line, onto ``device``.

    Parity: ``io::EdgeListReader`` (edge_list_reader.h:22-48): ``weighted``,
    ``remove_duplicates``, ``remove_self_edges``, ``read_undirected`` (adds
    (v, u) for every (u, v)) and ``square``; the result is n x n with
    n = the largest id + 1, as in the reference. Dtypes are torch dtypes."""

    def __init__(self, filename: str, weighted: bool = False, remove_duplicates: bool = False,
                 remove_self_edges: bool = False, read_undirected: bool = True, square: bool = False,
                 id_dtype=None, value_dtype=torch.float32, device=DEFAULT_DEVICE):
        self.filename = filename
        self.weighted = weighted
        self.remove_duplicates = remove_duplicates
        self.remove_self_edges = remove_self_edges
        self.read_undirected = read_undirected
        self.square = square
        self.id_dtype = id_dtype
        self.value_dtype = value_dtype
        self.device = target_device(device)

    def _load_body(self) -> np.ndarray:
        try:
            return np.loadtxt(self.filename, comments=("%", "#"), dtype=np.float64, ndmin=2)
        except (OSError, ValueError) as e:
            raise ReaderError(f"Cannot read edge list {self.filename}: {e}")

    def read_coo(self) -> COO:
        body = self._load_body()
        if body.size == 0:
            body = body.reshape(0, 3 if self.weighted else 2)
        if self.weighted and body.shape[1] < 3:
            raise ReaderError("weighted=True but file has no weight column")
        n_ids = int(body[:, :2].max(initial=-1)) + 1
        id_dtype = self.id_dtype or index_dtype_for(n_ids)
        dev = self.device
        row = narrow_ids(torch.from_numpy(np.ascontiguousarray(body[:, 0])), id_dtype).to(dev)
        col = narrow_ids(torch.from_numpy(np.ascontiguousarray(body[:, 1])), id_dtype).to(dev)
        vals = torch.from_numpy(np.ascontiguousarray(body[:, 2])).to(self.value_dtype).to(dev) if self.weighted \
            else None
        if self.remove_self_edges:
            keep = row != col
            row, col = row[keep], col[keep]
            if vals is not None:
                vals = vals[keep]
        if self.read_undirected:
            row, col = torch.cat([row, col]), torch.cat([col, row])
            if vals is not None:
                vals = torch.cat([vals, vals])
        if self.remove_duplicates:
            idx = _first_occurrences(row, col)
            row, col = row[idx], col[idx]
            if vals is not None:
                vals = vals[idx]
        n = int(torch.max(row.max(), col.max())) + 1 if row.numel() else 0
        return COO.new(row, col, vals, shape=(n, n))

    def read_csr(self) -> CSR:
        from ..convert.kernels import coo_to_csr

        return coo_to_csr(self.read_coo())


class EdgeListWriter:
    """Writes COO/CSR from any device as a text edge list
    (edge_list_writer.cc parity; a value is written as numpy prints a
    scalar of its dtype, as the JAX writer writes it)."""

    def __init__(self, filename: str, weighted: bool = False):
        self.filename = filename
        self.weighted = weighted

    def write_coo(self, coo: COO) -> None:
        coo = coo.to_host()
        row, col = coo.row.tolist(), coo.col.tolist()
        with open(self.filename, "w") as f:
            if self.weighted and coo.vals is not None:
                vals = coo.vals.numpy()
                f.write("".join(f"{r} {c} {v}\n" for r, c, v in zip(row, col, vals)))
            else:
                f.write("".join(f"{r} {c}\n" for r, c in zip(row, col)))

    def write_csr(self, csr: CSR) -> None:
        from ..convert.kernels import csr_to_coo

        self.write_coo(csr_to_coo(csr.to_host()))
