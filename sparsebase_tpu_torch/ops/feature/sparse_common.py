"""Triangle counts and Jaccard weights on the card without densification:
each one launch of kernel K6.

Counterpart of ``sparsebase_tpu/ops/feature/sparse_common.py``, under the
JAX names. The JAX module's block and chunk sizes (``E_CHUNK``, ``C_CHUNK``),
its groups of blocks launched from the host against the TPU watchdog
(``GROUP_BLOCKS``) and its wrapped-int32 sums (``utils/exact.py``) are TPU
workarounds and have no counterpart: K6 covers every entry in one launch and
adds in int64 (``ops/kernels/common_neighbors.py``). Semantics as there:
triangles count each distinct edge once and skip self-loops
(feature/triangle_count.cc:177-205); Jaccard counts instances
(feature/jaccard_weights_cuda.cu:70-91), equal to ``_jaccard_host`` bit for
bit. ``directed_triangle_count_sparse_device`` has no JAX counterpart: the
JAX package counts directed 3-cycles by a dense product up to 16,384
vertices and on the host past it; here K6's directed mode counts them at any
size. On CPU tensors K6's plain version runs.
"""

from __future__ import annotations

import torch

from ...convert.kernels import csr_to_csc
from ...formats.csr import CSR
from ..kernels.common_neighbors import common_neighbors


def triangle_count_sparse_device(csr: CSR, directed: bool = False) -> int:
    """The undirected triangle count of a symmetric pattern. As in the JAX
    package, ``directed=True`` raises: directed 3-cycles take
    ``directed_triangle_count_sparse_device``."""
    if directed:
        raise ValueError("sparse device path is undirected-only")
    if csr.nnz == 0:
        return 0
    return int(common_neighbors(csr, "triangles")) // 6


def directed_triangle_count_sparse_device(csr: CSR) -> int:
    """Directed 3-cycles ``u -> v -> w -> u``, each distinct edge counted once
    and self-loops ignored: ``csr_to_csc`` (K5, K3 on the card) gives each
    vertex's in-list, then one launch of K6 in directed mode."""
    if csr.nnz == 0:
        return 0
    n = csr.nrows
    square = csr if csr.ncols == n else CSR(csr.indptr, csr.indices, None, (n, n))
    return int(common_neighbors(square, "directed", csr_to_csc(square)))


def jaccard_weights_sparse_device(csr: CSR) -> torch.Tensor:
    """Per-entry Jaccard weights (float32, ``(nnz,)``), instance counting,
    self-loops kept."""
    return common_neighbors(csr, "jaccard")
