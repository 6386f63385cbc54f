"""K7 (a label-propagation round) built from other sources, timed beside the
port's own K7 in turns on one H100; every build's labels held equal to the
port's.

    python3 tools/torch_k7_ab.py [--nnz 100e6] [--seed 0] [--rounds 3] [--kron SCALE] [--cut T,...] SOURCE.cu ...

Each SOURCE.cu is built and timed in turns as ``tools/torch_ab.py`` says. A
source whose ``sb_label_prop_round`` takes ``nnz`` takes the port's C interface;
any other takes the interface of K7's first design
(``sb_label_prop_scratch_bytes(n, k)`` and no ``nnz`` in the round). The
inputs are ``chip_smoke.py``'s: path H's graph (path A's generator at
``--nnz`` entries, n = nnz / 16) at its first round (contiguous chunks,
alpha 0.1) and its last (the labels of ``partition_pipeline``, alpha 1),
the planted graph of the same size at the same two rounds (``--nnz 0``
leaves both out), and the K7 phase-2 edge cases (``chip_smoke.k7_cases``),
all made from ``--seed``. With ``--kron SCALE``, GAP's kron graph of the
benchmark's configuration (``benchmark/gen/kronecker.py``, its fixed graph
seed) at that scale, at the same two rounds: its hub rows hold up to
~10^5 entries at scale 22 and ~6 x 10^5 at 25. With ``--cut``, the same
graph at its first round with every row cut to its first T entries, for
each T given: what a round costs once no row is longer than T. On the
large graphs every build is also timed ten calls back to back, with
the device time per call and per kernel under ``torch.profiler``. Beside
them, the gather probe: ``torch.index_select`` of the graph's column ids
from an n-entry float32 vector, the random-gather floor a round sits on
(a probe, not a library call for K7's function). Any label that differs
from the port's stops the run with a non-zero exit.
"""
import argparse
import ctypes
import re
from pathlib import Path

import torch
import torch_ab

V = ctypes.c_void_p


def takes_nnz(src: str) -> bool:
    """Whether the source's ``sb_label_prop_round`` takes the entry count."""
    sig = re.search(r"sb_label_prop_round\(([^)]*)\)", Path(src).read_text())
    return bool(sig and "nnz" in sig.group(1))


def launcher(lib: str, with_nnz: bool):
    """``(csr, labels, k, alpha, cap)`` -> the new labels, through the library's C interface."""
    dll = ctypes.CDLL(lib)
    counts = 3 if with_nnz else 2  # (n, k, nnz) for the scratch and (n, nnz, k) for the round, or (n, k)
    scratch_bytes = dll.sb_label_prop_scratch_bytes
    scratch_bytes.argtypes, scratch_bytes.restype = [ctypes.c_int64] * counts, ctypes.c_int64
    fn = dll.sb_label_prop_round
    fn.argtypes, fn.restype = [V] * 4 + [ctypes.c_int64] * counts + [ctypes.c_float] * 3 + [V] * 3, ctypes.c_int

    def run(csr, labels, k, alpha, cap):
        n, nnz = csr.nrows, csr.nnz
        scratch = torch.empty((scratch_bytes(*((n, k, nnz) if with_nnz else (n, k))),), dtype=torch.uint8,
                              device=labels.device)
        out = torch.empty((n,), dtype=torch.int32, device=labels.device)
        w = csr.vals
        err = fn(csr.indptr.data_ptr(), csr.indices.data_ptr(), None if w is None else w.data_ptr(),
                 labels.data_ptr(), *((n, nnz, k) if with_nnz else (n, k)), alpha, cap, max(cap, 1.0),
                 scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"{lib}: CUDA error {err}"
        return out

    return run


def kron_csr(scale: int, seed: int, dev):
    """GAP's kron graph of the benchmark's configuration at ``scale``, as an
    unweighted CSR on ``dev`` (its row-major COO's columns, and K3's offsets)."""
    import json

    from benchmark.gen import kronecker
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels.indptr import indptr_from_sorted_rows

    root = Path(__file__).resolve().parents[1]
    cfg = dict(json.loads((root / "benchmark/configs/gap-kron-s25.json").read_text()), scale=scale)
    data = kronecker.make(cfg, seed, dev)
    n = data["n"]
    indptr = indptr_from_sorted_rows(data.pop("row"), n)
    return CSR(indptr, data.pop("col"), None, (n, n))


def cut_rows(csr, cut: int):
    """``csr`` with every row cut to its first ``cut`` entries."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.convert.kernels import indptr_from_counts

    deg = csr.indptr[1:] - csr.indptr[:-1]
    keep = torch.arange(csr.nnz, device=deg.device) - torch.repeat_interleave(csr.indptr[:-1], deg) < cut
    return CSR(indptr_from_counts(deg.clamp_max(cut)), csr.indices[keep], None, csr.shape)


def main() -> None:
    import chip_smoke as cs
    from benchmark.core.bounds import bound
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels import label_prop_round, label_prop_round_plain
    from sparsebase_tpu_torch.ops.kernels.indptr import indptr_from_sorted_rows
    from sparsebase_tpu_torch.ops.partition.labelprop import _chunks, _propagate

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--nnz", type=float, default=100e6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kron", type=int, default=0, help="scale of GAP's kron graph (0: none)")
    ap.add_argument("--cut", default="", help="comma-separated row lengths T: kron with its rows cut to T")
    args = ap.parse_args()
    libs = torch_ab.start(args.sources)
    kernels = [(Path(src).stem, launcher(lib, takes_nnz(src))) for src, lib in zip(args.sources, libs)]
    kernels.append(("port", lambda csr, lab, k, alpha, cap: label_prop_round(csr, lab, k, alpha, cap, csr.vals)))

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    nnz = int(args.nnz)
    n = nnz // 16
    k = cs.PARTITION_K
    inputs = []  # (label, csr, labels, k, alpha, cap, large)

    def both_rounds(name, csr):
        cap = 1.1 * csr.nrows / k
        first = _chunks(csr.nrows, k, dev)
        last = _propagate(csr, first, k, cap, None, cs.PARTITION_ROUNDS, stop_when_stable=False)
        return [(f"{name}, first round", csr, first, k, 1 / cs.PARTITION_ROUNDS, cap, True),
                (f"{name}, last round", csr, last, k, 1.0, cap, True)]

    if nnz:
        coo_a = cs.power_law_coo(g, dev, n, nnz)
        coo_p, _ = cs.planted_coo(g, dev, n - n % k, nnz)
        for name, coo in (("path H's graph", coo_a), ("the planted graph", coo_p)):
            inputs += both_rounds(name, CSR(indptr_from_sorted_rows(coo.row, coo.nrows), coo.col, None, coo.shape))
        del coo_a, coo_p
    if args.kron:
        csr = kron_csr(args.kron, args.seed, dev)
        inputs += both_rounds(f"kron s{args.kron}", csr)
        for cut in (int(t) for t in args.cut.split(",") if t):
            short = cut_rows(csr, cut)
            inputs.append((f"kron s{args.kron} cut to {cut}, first round", short, _chunks(short.nrows, k, dev), k,
                           1 / cs.PARTITION_ROUNDS, 1.1 * short.nrows / k, True))
    for label, csr, labels, kk in cs.k7_cases(g, dev, args.seed):
        inputs.append((f"edge: {label}", csr, labels, kk, 1.0, 1.1 * csr.nrows / kk, False))

    for label, csr, labels, kk, alpha, cap, large in inputs:
        deg = csr.indptr[1:] - csr.indptr[:-1]
        print(f"== {label}: n={csr.nrows}, {csr.nnz} entries, k={kk}, alpha={alpha}; longest row {int(deg.max())}, "
              f"entries in rows over 1024 / 4096: {int(deg[deg > 1024].sum()) / max(csr.nnz, 1):.2%} / "
              f"{int(deg[deg > 4096].sum()) / max(csr.nnz, 1):.2%}")
        del deg
        want = label_prop_round(csr, labels, kk, alpha, cap, csr.vals)
        if not large:
            plain = label_prop_round_plain(csr, labels, kk, alpha, cap, csr.vals)
            if csr.vals is None:
                cs.check_equal(f"{label}: port vs plain", want, plain)
        for name, fn in kernels:
            cs.check_equal(f"{label}: {name} vs port", fn(csr, labels, kk, alpha, cap), want)
        torch_ab.in_turns(kernels, lambda fn: fn(csr, labels, kk, alpha, cap), args.rounds)
        if not large:
            continue
        bound_s, by = bound("label_prop", n=csr.nrows, nnz=csr.nnz)
        bound_ms = bound_s * 1e3
        probe_x = torch.randn((csr.nrows,), generator=g, device=dev)
        probe = cs.cuda_ms(lambda: torch.index_select(probe_x, 0, csr.indices))
        print(f"  bound {bound_ms:.4f} ms ({by}); gather probe (index_select of the ids from an n-entry float32 "
              f"vector) {probe:.4f} ms")
        for name, fn in kernels:
            back = cs.cuda_ms(lambda: fn(csr, labels, kk, alpha, cap), batch=10)
            print(f"  {name:18s} back to back {back:.4f} ms ({bound_ms / back:.1%} of the bound); "
                  + torch_ab.device_summary(lambda: fn(csr, labels, kk, alpha, cap), 3))


if __name__ == "__main__":
    main()
