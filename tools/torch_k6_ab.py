"""K6 (common neighbours) built from other sources, timed beside the port's
own K6 in turns on one H100; every result held equal to the port's.

    python3 tools/torch_k6_ab.py [--feature-n 4000000] [--seed 0] SOURCE.cu ...

Each SOURCE.cu is built and timed in turns as ``tools/torch_ab.py`` says.
A source that exports ``sb_common_neighbors_scratch_words`` takes the port's
C interface (a scratch tensor and a queue); any other takes the row-array
interface of K6's first design (``sb_common_neighbors(indptr, ids, row, nnz,
mode, in_ptr, in_ids, out_w, out_sum, stream)``), its ``row`` array built in
the call. The graphs are ``chip_smoke.py``'s path F graph and its four
power-law graphs, made from ``--seed``. On the graphs of under 4M entries,
the first source and the port's K6 are also timed back to back, with the
host's time per call (no sync), the device's busy time per call and the
device operations per call, each with its device time, under
``torch.profiler``.
"""
import argparse
import ctypes
import statistics
import time
from pathlib import Path

import torch
import torch_ab

MODES = ("jaccard", "triangles", "directed")
SMALL_NNZ = 4_000_000
V = ctypes.c_void_p


def launcher(lib: str):
    """``(csr, mode, csc)`` -> K6's result, through the library's C interface."""
    dll = ctypes.CDLL(lib)
    fn = dll.sb_common_neighbors
    fn.restype = ctypes.c_int
    scratch_words = getattr(dll, "sb_common_neighbors_scratch_words", None)
    if scratch_words is not None:
        scratch_words.argtypes, scratch_words.restype = [ctypes.c_int64] * 2, ctypes.c_int64
        fn.argtypes = [V, V, ctypes.c_int64, ctypes.c_int64, ctypes.c_int] + [V] * 3 + [ctypes.c_int64] + [V] * 3
    else:
        fn.argtypes = [V] * 3 + [ctypes.c_int64, ctypes.c_int] + [V] * 5

    def run(csr, mode, csc=None):
        dev, n, nnz = csr.indices.device, csr.nrows, csr.nnz
        jac = mode == "jaccard"
        out = torch.empty((nnz,) if jac else (1,), dtype=torch.float32 if jac else torch.int64, device=dev)
        w, s = (out.data_ptr(), None) if jac else (None, out.data_ptr())
        ip, ii = (csc.indptr.data_ptr(), csc.indices.data_ptr()) if mode == "directed" else (None, None)
        stream = torch.cuda.current_stream().cuda_stream
        if scratch_words is not None:
            cap = max(1024, nnz // 16)
            scratch = torch.empty((scratch_words(n, cap),), dtype=torch.int64, device=dev)
            err = fn(csr.indptr.data_ptr(), csr.indices.data_ptr(), n, nnz, MODES.index(mode), ip, ii,
                     scratch.data_ptr(), cap, w, s, stream)
        else:  # the first design adds into *out_sum
            out.zero_()
            row = csr.row_of_nnz().to(torch.int32)
            err = fn(csr.indptr.data_ptr(), csr.indices.data_ptr(), row.data_ptr(), nnz, MODES.index(mode), ip, ii,
                     w, s, stream)
        assert err == 0, f"{lib}: CUDA error {err}"
        return out if jac else out.reshape(())

    return run


def main() -> None:
    import chip_smoke as cs
    from sparsebase_tpu_torch import CSC, CSR
    from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--feature-n", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    libs = torch_ab.start(args.sources)
    kernels = [(Path(src).stem, launcher(lib)) for src, lib in zip(args.sources, libs)]
    kernels.append(("port", common_neighbors))

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    fg = cs.feature_graph(g, dev, args.feature_n).convert(CSR)
    graphs = [("path F", fg, fg.convert(CSC), MODES)]
    for size in (cs.POWER_LAW_CARD, cs.POWER_LAW_HOST):
        graphs.append((f"power-law {size[0]} mirrored", cs.power_law_pattern(g, dev, *size), None, MODES[:2]))
        pd = cs.power_law_pattern(g, dev, *size, mirror=False)
        graphs.append((f"power-law {size[0]} unmirrored", pd, pd.convert(CSC), MODES[2:]))
    for label, graph, csc, modes in graphs:
        small = graph.nnz < SMALL_NNZ
        rounds, reps = (4, 25) if small else (3, 5)
        print(f"== {label}: n={graph.nrows}, {graph.nnz} entries, largest row {int(graph.degrees().max())}")
        for mode in modes:
            want = common_neighbors(graph, mode, csc)
            if small:
                cs.check_equal(f"{label} {mode}: port vs plain", want, common_neighbors_plain(graph, mode, csc))
            for name, fn in kernels:
                cs.check_equal(f"{label} {mode}: {name} vs port", fn(graph, mode, csc), want)
            torch_ab.in_turns(kernels, lambda fn: fn(graph, mode, csc), rounds, reps, prefix=f"{mode:9s} ")
            if not small:
                continue
            for name, fn in (kernels[0], kernels[-1]):
                back = cs.cuda_ms(lambda: fn(graph, mode, csc), batch=20, reps=10)
                host = []
                for _ in range(10):
                    torch.cuda.synchronize()
                    h0 = time.perf_counter()
                    for _ in range(10):
                        fn(graph, mode, csc)
                    host.append((time.perf_counter() - h0) / 10 * 1e3)
                torch.cuda.synchronize()
                print(f"  {mode:9s} {name:18s} back to back {back:.4f} ms; host per call (no sync) "
                      f"{statistics.median(host):.4f} ms; " + torch_ab.device_summary(lambda: fn(graph, mode, csc), 5))


if __name__ == "__main__":
    main()
