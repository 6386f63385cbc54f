"""What the host reorderers (SlashBurn, Rabbit, AMD, nested dissection)
share: a CSR's arrays on the host and the way back to the input's device.

These reorderers are host algorithms by design, in the reference as in the
JAX package: each step depends on the one before (a heap, a union-find, a
recursion), so they run on the CPU, in graphkit where it builds and else in
numpy. A CUDA CSR is copied to the host once, and the order goes back to
the input's device as int32: the port's convention for every reorderer.
"""

from __future__ import annotations

import torch

from ...formats.csr import CSR


def host_arrays(csr: CSR):
    """``(indptr, indices)`` of ``csr`` as int64 numpy arrays on the host,
    one copy each."""
    return csr.indptr.cpu().to(torch.int64).numpy(), csr.indices.cpu().to(torch.int64).numpy()


def to_order(order, csr: CSR) -> torch.Tensor:
    """An inverse permutation (numpy or CPU tensor) as int32 on ``csr``'s device."""
    return torch.as_tensor(order).to(torch.int32).to(csr.indptr.device)
