"""METIS .graph format reader/writer.

Counterpart of ``sparsebase_tpu/io/metis_graph.py``: the reference METIS graph I/O
(reference: src/sparsebase/io/metis_graph_reader.cc:16-107,
metis_graph_writer.cc). Format: header ``n m [fmt [ncon]]``; one line per
vertex listing ``[ncon vertex weights] (neighbor [edge weight])*``.
``fmt`` digits: 1 = edge weights, 1x = vertex weights. Each undirected
edge appears in both endpoint lists, so the reader emits 2m entries,
matching the reference (``m *= 2``, metis_graph_reader.cc:29).

The file is parsed line by line on the host; the graph's arrays are put
on the reader's device (CUDA unless the caller asks for the CPU), and the
writer takes a graph on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..formats.array import DenseArray
from ..formats.coo import COO
from ..objects import Graph
from ..utils.exceptions import ReaderError, WriterError
from .placement import DEFAULT_DEVICE, target_device


class MetisGraphReader:
    """Reads a METIS .graph file into a :class:`Graph`.

    Parity: ``io::MetisGraphReader`` (metis_graph_reader.cc). With
    ``convert_to_zero_index=False`` ids stay 1-based and the graph gains a
    phantom vertex 0 (n+1 vertices), exactly like the reference
    (metis_graph_reader.cc:30).
    """

    def __init__(self, filename: str, convert_to_zero_index: bool = True, device=DEFAULT_DEVICE):
        self.filename = filename
        self.convert_to_zero_index = convert_to_zero_index
        self.device = target_device(device)

    def read_graph(self) -> Graph:
        try:
            with open(self.filename) as f:
                lines = [l for l in f if not l.startswith("%")]
        except OSError:
            raise ReaderError("file does not exist!")
        if not lines:
            raise ReaderError("Empty METIS graph file")
        header = lines[0].split()
        n, m = int(header[0]), int(header[1])
        fmt = int(header[2]) if len(header) > 2 else 0
        ncon = int(header[3]) if len(header) > 3 else 0
        edge_weighted = fmt % 10 == 1
        # reference quirk: FMT in {1,11} with NCON absent implies NCON=1
        if fmt in (1, 11) and ncon == 0:
            ncon = 1
        vertex_weighted = fmt >= 10 and ncon > 0
        if len(lines) - 1 < n:
            raise ReaderError(f"Expected {n} vertex lines, found {len(lines) - 1}")

        shift = 1 if self.convert_to_zero_index else 0
        n_total = n + (0 if self.convert_to_zero_index else 1)
        rows, cols, vals = [], [], []
        vertex_weights: Optional[list] = [] if vertex_weighted else None
        if vertex_weighted and not self.convert_to_zero_index:
            vertex_weights.append(DenseArray(torch.zeros(ncon, dtype=torch.int32, device=self.device)))
        for i, line in enumerate(lines[1 : n + 1]):
            toks = line.split()
            pos = 0
            if vertex_weighted:
                w = torch.tensor([int(t) for t in toks[:ncon]], dtype=torch.int32, device=self.device)
                vertex_weights.append(DenseArray(w))
                pos = ncon
            node = i + (0 if self.convert_to_zero_index else 1)
            step = 2 if edge_weighted else 1
            for j in range(pos, len(toks), step):
                rows.append(node)
                cols.append(int(toks[j]) - shift)
                if edge_weighted:
                    vals.append(int(toks[j + 1]))
        dev = self.device
        row = torch.tensor(rows, dtype=torch.int32, device=dev)
        col = torch.tensor(cols, dtype=torch.int32, device=dev)
        v = torch.tensor(vals, dtype=torch.int32, device=dev) if edge_weighted else None
        coo = COO.new(row, col, v, shape=(n_total, n_total))
        return Graph(coo, ncon=ncon if vertex_weighted else 0, vertex_weights=vertex_weights)


class MetisGraphWriter:
    """Writes a :class:`Graph` as a METIS .graph file
    (metis_graph_writer.cc parity)."""

    def __init__(self, filename: str, convert_from_zero_index: bool = True):
        self.filename = filename
        self.convert_from_zero_index = convert_from_zero_index

    def write_graph(self, graph: Graph) -> None:
        fmt = graph.connectivity
        if fmt is None:
            raise WriterError("Graph has no connectivity")
        coo = fmt.convert(COO).to_host()
        row, col = coo.row.numpy(), coo.col.numpy()
        vals = None if coo.vals is None else coo.vals.numpy()
        n = coo.nrows
        edge_weighted = vals is not None
        vertex_weighted = graph.vertex_weights is not None
        ncon = graph.ncon if vertex_weighted else 0
        fmt_code = (10 if vertex_weighted else 0) + (1 if edge_weighted else 0)
        shift = 1 if self.convert_from_zero_index else 0
        with open(self.filename, "w") as f:
            header = f"{n} {row.shape[0] // 2}"
            if fmt_code or ncon:
                header += f" {fmt_code:03d}" if fmt_code else " 000"
                if ncon:
                    header += f" {ncon}"
            f.write(header + "\n")
            # group neighbors per vertex
            order = np.argsort(row, stable=True)
            row_s, col_s = row[order], col[order]
            vals_s = vals[order] if edge_weighted else None
            starts = np.concatenate([[0], np.cumsum(np.bincount(row_s, minlength=n))])
            for u in range(n):
                parts = []
                if vertex_weighted:
                    w = graph.vertex_weights[u].vals.cpu().numpy()
                    parts.extend(str(int(x)) for x in w)
                for e in range(starts[u], starts[u + 1]):
                    parts.append(str(int(col_s[e]) + shift))
                    if edge_weighted:
                        parts.append(str(int(vals_s[e])))
                f.write(" ".join(parts) + "\n")
