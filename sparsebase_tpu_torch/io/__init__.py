"""Sparse I/O: MTX, edge list, SBFF binary, METIS graph, PaToH hypergraph.

Counterpart of ``sparsebase_tpu/io`` (reference: src/sparsebase/io/). Readers
place what they read on the card unless the caller passes ``device="cpu"``;
writers take formats on any device.
"""

from .binary import (
    BinaryReaderOrderOne,
    BinaryReaderOrderTwo,
    BinaryWriterOrderOne,
    BinaryWriterOrderTwo,
    SbffObject,
)
from .edge_list import EdgeListReader, EdgeListWriter
from .metis_graph import MetisGraphReader, MetisGraphWriter
from .mtx import MTXReader, MTXWriter
from .patoh import PatohReader, PatohWriter
from .pigo import PigoEdgeListReader, PigoMTXReader

__all__ = [
    "MTXReader",
    "MTXWriter",
    "EdgeListReader",
    "EdgeListWriter",
    "BinaryReaderOrderOne",
    "BinaryReaderOrderTwo",
    "BinaryWriterOrderOne",
    "BinaryWriterOrderTwo",
    "SbffObject",
    "MetisGraphReader",
    "MetisGraphWriter",
    "PatohReader",
    "PatohWriter",
    "PigoMTXReader",
    "PigoEdgeListReader",
]
