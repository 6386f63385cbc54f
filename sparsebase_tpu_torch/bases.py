"""Static façades: the "easy" API.

Counterpart of ``sparsebase_tpu/bases.py`` (reference:
src/sparsebase/bases/iobase.h:46-390, reorder_base.h:29-708). Each façade
is a class of static one-liners over the readers, writers and ops.
``ReorderBase`` takes a reorderer class or any of the JAX package's short
names; an unknown name raises ``KeyError``.

The readers behind ``IOBase`` put what they read on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from .formats.array import DenseArray
from .formats.base import Format
from .formats.coo import COO
from .formats.csr import CSR
from .io.placement import DEFAULT_DEVICE


def _as_dense_array(order, fmt: Format) -> DenseArray:
    """``order`` as a ``DenseArray``; a raw array or tensor goes on ``fmt``'s
    device."""
    if isinstance(order, DenseArray):
        return order
    return DenseArray(torch.as_tensor(order, device=fmt.context.device))


class ReorderBase:
    """Parity: ``bases::ReorderBase`` (bases/reorder_base.h:29-708): reorder,
    permute and inverse-permutation one-liners."""

    @staticmethod
    def _resolve(reorderer_cls):
        """A Reorderer class, or its short name ("degree", "rcm", "gray",
        "slashburn", "boba", "amd", "metis" or "nested_dissection",
        "rabbit")."""
        if not isinstance(reorderer_cls, str):
            return reorderer_cls
        from .ops import reorder as _r

        aliases = {
            "degree": _r.DegreeReorder,
            "rcm": _r.RCMReorder,
            "gray": _r.GrayReorder,
            "slashburn": _r.SlashburnReorder,
            "boba": _r.BOBAReorder,
            "amd": _r.AMDReorder,
            "metis": _r.MetisReorder,
            "nested_dissection": _r.MetisReorder,
            "rabbit": _r.RabbitReorder,
        }
        key = reorderer_cls.lower()
        if key not in aliases:
            raise KeyError(f"unknown reorderer {reorderer_cls!r}; one of {sorted(aliases)}")
        return aliases[key]

    @staticmethod
    def _make(reorderer_cls, params):
        reorderer_cls = ReorderBase._resolve(reorderer_cls)
        if isinstance(params, dict):
            return reorderer_cls(**params)
        return reorderer_cls(params) if params is not None else reorderer_cls()

    @staticmethod
    def reorder(reorderer_cls, fmt: Format, params=None, context=None, convert_input=True):
        """Run a reorderer class or short name (Reorder, reorder_base.h:50-85)."""
        return ReorderBase._make(reorderer_cls, params).get_reorder(fmt, context=context,
                                                                    convert_input=convert_input)

    @staticmethod
    def reorder_cached(reorderer_cls, fmt: Format, params=None, context=None):
        return ReorderBase._make(reorderer_cls, params).get_reorder_cached(fmt, context=context)

    @staticmethod
    def permute2d(order, fmt, context=None, convert_input=True):
        """One order for rows and columns (Permute2D, reorder_base.h:145-192)."""
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(order, order).get_permutation(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def permute2d_cached(order, fmt, context=None):
        """(Permute2DCached): ``(intermediates, permuted)``, the conversions
        actually run."""
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(order, order).get_permutation_cached(fmt, context=context)

    @staticmethod
    def permute1d_cached(order, arr, context=None):
        """(Permute1DCached, reorder_base.h:624-)."""
        from .ops.permute import PermuteOrderOne

        op = PermuteOrderOne(order)
        return op.execute_cached(op.params, arr, context=context)

    @staticmethod
    def permute2d_rowwise(order, fmt, context=None, convert_input=True):
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(order, None).get_permutation(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def permute2d_colwise(order, fmt, context=None, convert_input=True):
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(None, order).get_permutation(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def permute2d_row_columnwise(row_order, col_order, fmt, context=None, convert_input=True):
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(row_order, col_order).get_permutation(fmt, context=context,
                                                                     convert_input=convert_input)

    @staticmethod
    def permute1d(order, arr, context=None, convert_input=True):
        from .ops.permute import PermuteOrderOne

        return PermuteOrderOne(order).get_permutation(arr, context=context, convert_input=convert_input)

    @staticmethod
    def inverse_permutation(perm):
        """(InversePermutation, reorder_base.h:663-694)."""
        from .ops.permute import inverse_permutation as inv

        return inv(perm)

    @staticmethod
    def heatmap(fmt, order_r, order_c, num_parts: int = 8, context=None):
        """(Heatmap, reorder_base.h:696-708): the block density grid of
        ``fmt`` under a row and a column order (raw orders are wrapped in
        ``DenseArray`` objects on ``fmt``'s device)."""
        from .ops.reorder.heatmap import ReorderHeatmap

        return ReorderHeatmap(num_parts).get_heatmap(fmt, _as_dense_array(order_r, fmt),
                                                     _as_dense_array(order_c, fmt), context=context)

    @staticmethod
    def heatmap_with_stats(fmt, order_r, order_c, num_parts: int = 8, context=None):
        """``(heatmap, stats)`` in one pass; the stats are the mean and
        largest bandwidth, the count of non-empty blocks and the block
        bandwidth (reorder_heatmap.cc:58-106)."""
        from .ops.reorder.heatmap import ReorderHeatmap

        return ReorderHeatmap(num_parts).get_heatmap_with_stats(fmt, _as_dense_array(order_r, fmt),
                                                                _as_dense_array(order_c, fmt), context=context)


class GraphFeatureBase:
    """Parity: ``bases::GraphFeatureBase`` (bases/graph_feature_base.h:20-135),
    with a general ``extract`` that runs the fused extractor."""

    @staticmethod
    def get_degrees(fmt: Format, context=None, convert_input=True):
        from .ops.feature import Degrees

        return Degrees().get_degrees(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def get_degree_distribution(fmt: Format, context=None, convert_input=True):
        from .ops.feature import DegreeDistribution

        return DegreeDistribution().get_distribution(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def get_degrees_cached(fmt: Format, context=None):
        """``(intermediates, degrees)``: the conversions actually run."""
        from .ops.feature import Degrees

        op = Degrees()
        return op.execute_cached(op.params, fmt, context=context)

    @staticmethod
    def get_fill_in(fmt: Format, context=None, convert_input=True):
        """nnz(L) of the symbolic factorisation in the current row order, the
        fill an AMD or nested-dissection order is judged on (no reference
        façade: the reference leaves fill to SuiteSparse, amd_reorder.cc:29-57)."""
        from .ops.feature import FillIn

        return FillIn().get_fill(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def extract(features, fmt: Format, context=None, convert_input=True):
        """Fused extraction of several features (``feature::Extractor::Extract``)."""
        from .ops.feature import FeatureExtractor

        return FeatureExtractor().extract(fmt, features=features, context=context, convert_input=convert_input)


class IOBase:
    """Parity: ``bases::IOBase`` (bases/iobase.h:46-390): static read and
    write helpers. ``**kw`` goes to the reader (``device=`` among them)."""

    # -- MTX -----------------------------------------------------------------
    @staticmethod
    def read_mtx_to_csr(filename: str, convert_to_zero_index: bool = True, **kw) -> CSR:
        from .io.mtx import MTXReader

        return MTXReader(filename, convert_to_zero_index, **kw).read_csr()

    @staticmethod
    def read_mtx_to_coo(filename: str, convert_to_zero_index: bool = True, **kw) -> COO:
        from .io.mtx import MTXReader

        return MTXReader(filename, convert_to_zero_index, **kw).read_coo()

    @staticmethod
    def read_mtx_to_array(filename: str, **kw) -> DenseArray:
        from .io.mtx import MTXReader

        return MTXReader(filename, **kw).read_array()

    # native mmap + OpenMP parse where the fastio library builds
    @staticmethod
    def read_pigo_mtx_to_csr(filename: str, convert_to_zero_index: bool = True, **kw) -> CSR:
        from .io.pigo import PigoMTXReader

        return PigoMTXReader(filename, convert_to_zero_index, **kw).read_csr()

    @staticmethod
    def read_pigo_mtx_to_coo(filename: str, convert_to_zero_index: bool = True, **kw) -> COO:
        from .io.pigo import PigoMTXReader

        return PigoMTXReader(filename, convert_to_zero_index, **kw).read_coo()

    # -- edge list -----------------------------------------------------------
    @staticmethod
    def read_edge_list_to_csr(filename: str, **kw) -> CSR:
        from .io.edge_list import EdgeListReader

        return EdgeListReader(filename, **kw).read_csr()

    @staticmethod
    def read_edge_list_to_coo(filename: str, **kw) -> COO:
        from .io.edge_list import EdgeListReader

        return EdgeListReader(filename, **kw).read_coo()

    @staticmethod
    def read_pigo_edge_list_to_csr(filename: str, **kw) -> CSR:
        from .io.pigo import PigoEdgeListReader

        return PigoEdgeListReader(filename, **kw).read_csr()

    @staticmethod
    def read_pigo_edge_list_to_coo(filename: str, **kw) -> COO:
        from .io.pigo import PigoEdgeListReader

        return PigoEdgeListReader(filename, **kw).read_coo()

    # -- SBFF binary ---------------------------------------------------------
    @staticmethod
    def read_binary_to_csr(filename: str, device=DEFAULT_DEVICE) -> CSR:
        from .io.binary import BinaryReaderOrderTwo

        return BinaryReaderOrderTwo(filename, device).read_csr()

    @staticmethod
    def read_binary_to_coo(filename: str, device=DEFAULT_DEVICE) -> COO:
        from .io.binary import BinaryReaderOrderTwo

        return BinaryReaderOrderTwo(filename, device).read_coo()

    @staticmethod
    def read_binary_to_array(filename: str, device=DEFAULT_DEVICE) -> DenseArray:
        from .io.binary import BinaryReaderOrderOne

        return BinaryReaderOrderOne(filename, device).read_array()

    @staticmethod
    def write_csr_to_binary(csr: CSR, filename: str) -> None:
        from .io.binary import BinaryWriterOrderTwo

        BinaryWriterOrderTwo(filename).write_csr(csr)

    @staticmethod
    def write_coo_to_binary(coo: COO, filename: str) -> None:
        from .io.binary import BinaryWriterOrderTwo

        BinaryWriterOrderTwo(filename).write_coo(coo)

    @staticmethod
    def write_array_to_binary(arr: DenseArray, filename: str) -> None:
        from .io.binary import BinaryWriterOrderOne

        BinaryWriterOrderOne(filename).write_array(arr)

    # -- MTX writing ---------------------------------------------------------
    @staticmethod
    def write_coo_to_mtx(coo: COO, filename: str, **kw) -> None:
        from .io.mtx import MTXWriter

        kw.setdefault("field", "pattern" if coo.vals is None else "real")
        MTXWriter(filename, **kw).write_coo(coo)

    @staticmethod
    def write_csr_to_mtx(csr: CSR, filename: str, **kw) -> None:
        from .io.mtx import MTXWriter

        kw.setdefault("field", "pattern" if csr.vals is None else "real")
        MTXWriter(filename, **kw).write_csr(csr)

    @staticmethod
    def write_array_to_mtx(arr: DenseArray, filename: str, **kw) -> None:
        from .io.mtx import MTXWriter

        MTXWriter(filename, format="array", **kw).write_array(arr)
