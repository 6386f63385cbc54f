"""The window's call, on a mesh of the cards that hold the blocks:
``ShardedCSR.from_coo_blocks`` (each card buckets its block by owner, the
entries cross to their owners' cards in one ``all_to_all`` a field, each
owner sorts them by (row, column) and builds its offsets), ``with_halo``,
then ``iterations`` x ``x = halo.spmv(sh, x, mesh) / scale``, and a
synchronise of every card of the mesh.

``scale`` is A's largest row 2-norm, a lower bound of its spectral radius
(A is symmetric and not negative), so the iterate neither shrinks nor
grows by more than a few times a step. The traffic file says why not
``||A||_inf``. The work of a call is the input's entries. The comparison:
each row block's CSR bit for bit against the reference's, and the last
iterate against the float64 one.
"""

import torch

from benchmark.reference import compare
from benchmark.reference import sharded as ref


def prepare(inputs, traffic):
    from sparsebase_tpu_torch.parallel import make_mesh

    return {"rows": inputs["rows"], "cols": inputs["cols"], "vals": inputs["vals"], "n": inputs["n"],
            "mesh": make_mesh(devices=inputs["devices"]), "x": inputs["x"],
            "iterations": int(traffic["iterations"]), "scale": _scale(inputs)}


def run(state):
    from sparsebase_tpu_torch.parallel import ShardedCSR, halo

    n, mesh = state["n"], state["mesh"]
    sh = ShardedCSR.from_coo_blocks(state["rows"], state["cols"], state["vals"], (n, n), mesh).with_halo()
    x = state["x"]
    for _ in range(state["iterations"]):
        x = halo.spmv(sh, x, mesh) / state["scale"]
    for dev in {d for d in mesh.axis_devices(mesh.axis_names[0]) if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return sh, x


def work(inputs, traffic):
    return sum(r.numel() for r in inputs["rows"])


def shapes(inputs, traffic):
    return {"n": inputs["n"], "nnz": work(inputs, traffic), "cards": len(inputs["devices"]),
            "iterations": int(traffic["iterations"])}


def tensors(out):
    sh, x = out
    counts = sh.nnz_counts
    return {"indptr": list(sh.indptr), "cols": [c[:k] for c, k in zip(sh.indices, counts)],
            "vals": [v[:k] for v, k in zip(sh.vals, counts)], "x": x}


def _scale(inputs):
    return ref.largest_row_norm(inputs["rows"], inputs["cols"], inputs["vals"], inputs["n"], inputs["x"].device)


def judge(got, inputs, traffic):
    """``csr_mismatch``: entries of the row blocks' CSRs that differ from the
    reference's (offsets, columns, value bits); ``x_err``: the widest gap of
    the last iterate from the float64 one, over its largest magnitude."""
    n = inputs["n"]
    args = (inputs["rows"], inputs["cols"], inputs["vals"])
    bad = ref.csr_mismatches(got, *args, n, n)
    want = ref.iterate(*args, inputs["x"], n, int(traffic["iterations"]), _scale(inputs))
    return {"csr_mismatch": float(bad), "x_err": compare.finite(ref.iterate_gap(got["x"], want))}


def control(inputs, traffic):
    """The reference's row blocks and iterate, computed in bfloat16."""
    n = inputs["n"]
    args = (inputs["rows"], inputs["cols"], inputs["vals"])
    out = ref.control_csr(*args, n, n, inputs["devices"], torch.bfloat16)
    x = ref.iterate(*args, inputs["x"], n, int(traffic["iterations"]), _scale(inputs), torch.bfloat16)
    out["x"] = x.to(torch.float32)
    return out
