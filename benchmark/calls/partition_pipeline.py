"""The window's call: ``partition_pipeline(coo, x, k, num_iters)``.

COO -> CSR (K3) -> ``num_iters`` rounds of label propagation into ``k``
parts from contiguous chunks (K7 each) -> rows grouped by part, a stable
rank of the labels (K5) -> symmetric permutation (K4) -> SpMV (K2). The
work of a call is the input's entries. The comparison: the labels exactly,
then the permuted CSR bit for bit and ``y`` against ``P A x`` in float64,
all worked out again from the inputs.
"""

import torch

from benchmark.reference import compare
from benchmark.reference import csr as ref_csr
from benchmark.reference import labelprop as ref_lp


def prepare(inputs, traffic):
    from sparsebase_tpu_torch import COO

    n = inputs["n"]
    return {"coo": COO(inputs["row"], inputs["col"], inputs["vals"], (n, n)), "x": inputs["x"],
            "k": int(traffic["k"]), "num_iters": int(traffic["num_iters"])}


def run(state):
    from sparsebase_tpu_torch.models.pipelines import partition_pipeline

    return partition_pipeline(state["coo"], state["x"], k=state["k"], num_iters=state["num_iters"])


def work(inputs, traffic):
    return inputs["row"].numel()


def shapes(inputs, traffic):
    return {"n": inputs["n"], "ncols": inputs["n"], "nnz": inputs["row"].numel(), "k": int(traffic["k"]),
            "rounds": int(traffic["num_iters"])}


def tensors(out):
    permuted, y, labels = out
    return {"indptr": permuted.indptr, "indices": permuted.indices, "vals": permuted.vals, "y": y, "labels": labels}


def _labels(inputs, traffic):
    n = inputs["n"]
    indptr = ref_csr.indptr_from_rows(inputs["row"], n)
    labels = ref_lp.propagate(inputs["row"], inputs["col"], indptr[1:] - indptr[:-1], n, int(traffic["k"]),
                              int(traffic["num_iters"]))
    return indptr, labels


def judge(got, inputs, traffic):
    indptr, labels = _labels(inputs, traffic)
    g = got["labels"]
    bad = abs(g.numel() - labels.numel()) + int((g[:labels.numel()].long() != labels[:g.numel()]).sum())
    numbers = {"label_mismatch": float(bad)}
    numbers.update(compare.permutation_numbers(got, inputs, ref_csr.stable_rank(labels), indptr))
    return numbers


def control(inputs, traffic):
    indptr, labels = _labels(inputs, traffic)
    out = compare.permuted_control(inputs, ref_csr.stable_rank(labels), indptr)
    out["labels"] = labels.to(torch.int32)
    return out
