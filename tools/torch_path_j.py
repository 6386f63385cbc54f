"""Paths J, K, L and M of ``chip_smoke.py`` alone, at their full size, on one
card: the kernels' build, path A's COO and source CSR (``--nnz`` entries,
``--seed``), path G's 32,768-vertex power-law graph (the halo check's), then
``chip_smoke.path_j`` (its phases 3 and 4; the components check's 8-block
graph drawn last) and ``chip_smoke.path_k`` on
path J's meshes (its graphs drawn after path J's; path B's band of
``--band-nnz`` entries), then ``chip_smoke.path_l`` (its own meshes and
graphs), then ``chip_smoke.path_m`` (its own graph from ``--seed``, its two
processes, path N's twelve functions, path O's multilevel calls, SlashBurn
and containers, and path P's rings, ``sharded2d``, containers, suite and
experiment in one process and in both; path P's processes hold their ``run_distributed`` tables to path L's where ``l`` runs
too, else to one made in the parent). ``--paths`` picks some of ``j``,
``k``, ``l`` and ``m``; ``--paths l`` or ``m`` makes none of path A's
graphs. The draws differ from the whole script's, which makes other graphs
first; path M's graph is the same.

    python3 tools/torch_path_j.py [--nnz 100e6] [--band-nnz 64e6] [--paths jklm] [--seed 0]

Exits non-zero if any check fails; the last line is the paths' launch
counts and K2's largest difference from the plain SpMV on path J.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nnz", type=float, default=100e6)
    ap.add_argument("--band-nnz", type=float, default=64e6)
    ap.add_argument("--paths", default="jklm", help="some of j, k, l and m (default jklm)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not args.paths or set(args.paths) - set("jklm"):
        ap.error(f"--paths {args.paths!r}: some of j, k, l and m")
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels import indptr_plain

    t0 = time.perf_counter()
    dev = cs.phase_device()
    cs.phase_build()
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    out = {}
    if set(args.paths) & set("jk"):
        nnz = int(args.nnz)
        n = max(nnz // 16, 1)
        coo = cs.power_law_coo(g, dev, n, nnz)
        x = torch.randn((n,), generator=g, device=dev)
        src = CSR(indptr_plain(coo.row, n), coo.col, coo.vals, coo.shape)
        host_graph = cs.power_law_pattern(g, dev, *cs.HOST_REORDER_GRAPH)
        if "j" in args.paths:
            out["J"], out["max_abs_err"], j = cs.path_j(g, dev, coo, src, x, host_graph)
        else:
            j = cs.PathJ(g, dev, coo, src, x, host_graph)
        if "k" in args.paths:
            out["K"] = cs.path_k(g, dev, j, n - n % cs.PARTITION_K, nnz // 4,
                                 int(args.band_nnz) // (2 * cs.BAND_HALF_WIDTH + 1))
        del j, coo, x, src, host_graph
    suite = None
    if "l" in args.paths:
        out["L"], suite = cs.path_l(g, dev)
    if "m" in args.paths:
        out["M"], out["N"], out["O"], out["P"], out["max_abs_err M"] = cs.path_m(dev, args.seed, suite=suite)
    print(f"tools/torch_path_j.py: {time.perf_counter() - t0:.1f} s in all")
    print(out)


if __name__ == "__main__":
    main()
