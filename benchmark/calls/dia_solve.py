"""The window's call: ``coo.convert(CSR)`` -> ``convert(DIA)`` ->
``iterations`` x ``spmv(dia, x)``, each next ``x`` the last ``y`` over
``||A||_inf`` (HPCG's iterations of a CG set on the banded format, through
tutorial 007's path: K3, then the CSR -> DIA conversion, then K1).

The benchmark's own spans ``bench:convert:COO->CSR``,
``bench:convert:CSR->DIA`` and ``bench:spmv`` mark the stages for the
traced run. The work of a call is the input's entries. The comparison:
the band's offsets and cells bit for bit against the band of the input,
and the last iterate against the float64 one.
"""

import torch

from benchmark.reference import compare


def prepare(inputs, traffic):
    from sparsebase_tpu_torch import COO

    n = inputs["n"]
    return {"coo": COO(inputs["row"], inputs["col"], inputs["vals"], (n, n)), "x": inputs["x"],
            "iterations": int(traffic["iterations"]), "scale": _scale(inputs)}


def run(state):
    from torch.profiler import record_function

    from sparsebase_tpu_torch import CSR, DIA, spmv

    with record_function("bench:convert:COO->CSR"):
        csr = state["coo"].convert(CSR)
    with record_function("bench:convert:CSR->DIA"):
        dia = csr.convert(DIA)
    del csr
    x = state["x"]
    with record_function("bench:spmv"):
        for _ in range(state["iterations"]):
            x = spmv(dia, x) / state["scale"]
    return dia, x


def work(inputs, traffic):
    return inputs["row"].numel()


def shapes(inputs, traffic):
    n = inputs["n"]
    diff = inputs["col"].long() - inputs["row"].long()
    return {"n": n, "m": n, "nnz": inputs["row"].numel(), "ndiag": int(torch.unique(diff).numel()),
            "iterations": int(traffic["iterations"])}


def tensors(out):
    dia, x = out
    return {"offsets": dia.offsets, "data": dia.data, "x": x}


def _scale(inputs):
    """||A||_inf of the input: the largest row sum of |a_ij|."""
    absrow = torch.zeros((inputs["n"],), dtype=torch.float64, device=inputs["vals"].device)
    absrow.index_add_(0, inputs["row"].long(), inputs["vals"].abs().to(torch.float64))
    return float(absrow.max())


def judge(got, inputs, traffic):
    return compare.band_numbers(got, inputs, int(traffic["iterations"]), _scale(inputs))


def control(inputs, traffic):
    return compare.band_control(inputs, int(traffic["iterations"]), _scale(inputs))
