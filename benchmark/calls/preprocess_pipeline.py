"""The window's call: ``preprocess_pipeline(coo, x)``, the port's main path.

COO -> CSR (K3) -> degree rank (K5) -> symmetric permutation (K4, and for
rows past its block tier the long-row route) -> SpMV (K2). The work of a
call is the input's entries. The comparison: the permuted CSR bit for bit
and ``y`` against ``P A x`` in float64, both worked out again from the
inputs (the degrees, their stable rank, the permutation, the SpMV).
"""

from benchmark.reference import compare
from benchmark.reference import csr as ref_csr


def prepare(inputs, traffic):
    from sparsebase_tpu_torch import COO

    n = inputs["n"]
    return {"coo": COO(inputs["row"], inputs["col"], inputs["vals"], (n, n)), "x": inputs["x"]}


def run(state):
    from sparsebase_tpu_torch import preprocess_pipeline

    return preprocess_pipeline(state["coo"], state["x"])


def work(inputs, traffic):
    return inputs["row"].numel()


def shapes(inputs, traffic):
    return {"n": inputs["n"], "ncols": inputs["n"], "nnz": inputs["row"].numel()}


def tensors(out):
    permuted, y = out
    return {"indptr": permuted.indptr, "indices": permuted.indices, "vals": permuted.vals, "y": y}


def _rank(inputs):
    indptr = ref_csr.indptr_from_rows(inputs["row"], inputs["n"])
    return indptr, ref_csr.stable_rank(indptr[1:] - indptr[:-1])


def judge(got, inputs, traffic):
    indptr, rank = _rank(inputs)
    return compare.permutation_numbers(got, inputs, rank, indptr)


def control(inputs, traffic):
    indptr, rank = _rank(inputs)
    return compare.permuted_control(inputs, rank, indptr)
