"""HTML dashboard visualizer (reference-report parity).

Counterpart of ``sparsebase_tpu/utils/visualizer.py`` (reference Visualizer,
src/sparsebase/utils/visualizer.cc:18-578 + style.css, 744 LoC): the same
HTML, character for character, a standalone styled dashboard with

* a header (matrix name, shape, nnz) — ``initHtml``,
* a top row of non-ordering-based feature cards — visualizer.cc:120-133,
* one **section per ordering** (natural first, then every alternative —
  ``plotNaturalOrdering`` / ``plotAlternateOrderings``): left a
  bucketized-density spy plot with per-cell hover tooltips and empty
  cells marked ``×`` (the reference's plotly ``hovertemplate`` and 'X'
  annotations, visualizer.cc:236-268, rendered here as dependency-free
  inline SVG — no CDN scripts), middle the ordering-based feature list
  (heatmap stats + any user-supplied values — visualizer.cc:200-210),
  right a graphical box with a per-row-block nnz histogram (the
  reference leaves "insert graph here" placeholders, :216-221),
* ``plot_edges_by_weights``: bucket weights of |values| instead of
  counts — visualizer.cc:172-177.

Density grids + bandwidth stats come from :class:`ReorderHeatmap` (one
fused pass), run on the CSR's own device: the CSR stays where it is, and
only each b×b grid and its four stats cross to the host for the SVG. The
``|values|`` grid of ``plot_edges_by_weights`` is one accumulating
``index_put_`` in float64 on the same device. Unlike the reference (whose
visualizer is not wired into any build target), this one is public API
with a CLI::

    python -m sparsebase_tpu_torch.utils.visualizer matrix.mtx out.html \
        --orderings rcm,degree,amd [--parts 64] [--weights] [--trace DIR] [--device cpu]

which reads the matrix onto the card unless given ``--device cpu``, writes
the dashboard and (with ``--trace``) a ``torch.profiler`` Chrome trace whose
spans carry the port's names (``utils/tracing.py``): ``sbtorch:op:`` and
``sbtorch:convert:`` from the dispatch and the conversions, and
``sbtorch:csr_to_dia:``, ``sbtorch:pipeline:``, ``sbtorch:stage:`` and
``sbtorch:relocate:`` from the steps inside them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..formats.csr import CSR

_CSS = """
:root { --background:#fafaf7; --header:#f0efe9; --card:#ffffff;
        --line:#e2e0da; --text:#1a1a18; --title:#14324f; }
body { font-family:-apple-system,'Segoe UI',sans-serif; margin:0;
       background:var(--background); color:var(--text); }
.header { background:var(--header); padding:1rem 2rem;
          border-bottom:1px solid var(--line); }
.header h1 { margin:0; color:var(--title); font-size:1.4rem; }
.header p { margin:.3rem 0 0; color:#555; font-size:.9rem; }
.content { padding:1.5rem 2rem; }
.non-ordering-based-features { display:flex; flex-wrap:wrap; gap:1rem;
                               margin-bottom:1.5rem; }
.card { background:var(--card); border:1px solid var(--line);
        border-radius:8px; padding:.7rem 1.1rem; }
.card h3 { margin:0 0 .3rem; font-size:.8rem; color:var(--title);
           text-transform:uppercase; letter-spacing:.04em; }
.card p { margin:0; font-size:1.1rem; }
.section { display:flex; gap:1.5rem; align-items:flex-start;
           background:var(--card); border:1px solid var(--line);
           border-radius:8px; padding:1rem; margin-bottom:1.5rem; }
.left-section h2 { margin:0 0 .6rem; font-size:1.05rem;
                   color:var(--title); }
.middle-section .feature-box h3, .right-section .graphical-box h3 {
  margin:0 0 .4rem; font-size:.85rem; color:var(--title); }
.feature-box ul { margin:0; padding-left:1.1rem; font-size:.85rem; }
.feature-box li { margin:.15rem 0; }
figure { margin:0; }
figcaption { margin-top:.4rem; font-size:.8rem; color:#555; }
"""


def _spy_svg(density: np.ndarray, size: int = 240) -> str:
    """b×b density grid as SVG: hover tooltips per cell (the plotly
    ``hovertemplate`` analogue) and ``×`` marks on empty cells (the
    reference's 'X' annotations, visualizer.cc:252-268)."""
    b = density.shape[0]
    cell = size / b
    mx = float(density.max()) or 1.0
    parts = []
    mark_empty = b <= 32  # the reference annotates every empty cell;
    # beyond ~32² that is visual noise, so marks are kept for small grids
    for i in range(b):
        for j in range(b):
            v = float(density[i, j])
            if v > 0:
                alpha = 0.15 + 0.85 * (v / mx)
                parts.append(
                    f'<rect x="{j * cell:.1f}" y="{i * cell:.1f}" '
                    f'width="{cell:.1f}" height="{cell:.1f}" '
                    f'fill="rgb(47,79,140)" fill-opacity="{alpha:.2f}">'
                    f"<title>X: {j}\nY: {i}\nNNZ(s): {v:g}</title></rect>"
                )
            elif mark_empty:
                parts.append(
                    f'<text x="{(j + 0.5) * cell:.1f}" y="{(i + 0.72) * cell:.1f}" '
                    f'text-anchor="middle" font-size="{cell * 0.5:.1f}" '
                    f'fill="#c8c6c0">×</text>'
                )
    return (
        f'<svg width="{size}" height="{size}" style="border:1px solid #ccc">'
        + "".join(parts)
        + "</svg>"
    )


def _histogram_svg(values: np.ndarray, width: int = 180, height: int = 90,
                   caption: str = "") -> str:
    """Small bar chart (per-row-block nnz) for the graphical box."""
    k = len(values)
    if k == 0:
        return "<svg></svg>"
    mx = float(values.max()) or 1.0
    bw = width / k
    bars = []
    for i, v in enumerate(values):
        h = height * float(v) / mx
        bars.append(
            f'<rect x="{i * bw:.1f}" y="{height - h:.1f}" width="{max(bw - 1, 1):.1f}" '
            f'height="{h:.1f}" fill="rgb(47,79,140)" fill-opacity="0.8">'
            f"<title>block {i}: {v:g}</title></rect>"
        )
    return (
        f'<figure><svg width="{width}" height="{height}">'
        + "".join(bars)
        + f"</svg><figcaption>{caption}</figcaption></figure>"
    )


class Visualizer:
    """Build the styled multi-ordering HTML dashboard.

    Usage::

        viz = Visualizer(csr, num_parts=64, name="ash958")
        viz.add_ordering("rcm", rcm_order)
        viz.add_ordering("degree", deg_order, features={"note": "asc"})
        viz.add_features({"triangles": 42})   # non-ordering-based cards
        viz.write_html("report.html")
    """

    def __init__(
        self,
        csr: CSR,
        num_parts: int = 64,
        title: str = "sparsebase_tpu report",
        name: Optional[str] = None,
        plot_edges_by_weights: bool = False,
    ):
        self.csr = csr
        self.num_parts = min(num_parts, min(csr.shape))
        self.title = title
        self.name = name or title
        self.plot_edges_by_weights = bool(plot_edges_by_weights)
        self._orderings: Dict[str, Tuple[torch.Tensor, torch.Tensor, Dict]] = {}
        self._features: Dict[str, object] = {}

    def add_ordering(self, name: str, row_order, col_order=None,
                     features: Optional[Dict] = None) -> None:
        """Orders (tensors or arrays) are kept on the CSR's device."""
        device = self.csr.indptr.device
        row_order = torch.as_tensor(row_order, device=device)
        col_order = row_order if col_order is None else torch.as_tensor(col_order, device=device)
        self._orderings[name] = (row_order, col_order, dict(features or {}))

    def add_features(self, features: Dict[str, object]) -> None:
        self._features.update({k: v for k, v in features.items()})

    def _density(self, row_order, col_order):
        """(grid, stats) in one fused pass (reorder_heatmap.cc:58-106) on the
        CSR's device; the grid comes back as a numpy array."""
        from ..formats.array import DenseArray
        from ..ops.reorder.heatmap import ReorderHeatmap

        heat, stats = ReorderHeatmap(self.num_parts).get_heatmap_with_stats(
            self.csr, DenseArray(row_order), DenseArray(col_order)
        )
        b = self.num_parts
        grid = heat.vals.view(b, b)
        if self.plot_edges_by_weights and self.csr.vals is not None:
            # re-bucket |values| instead of counts (visualizer.cc:172-177)
            n, m = self.csr.shape
            r = row_order[self.csr.row_of_nnz().long()].long()
            c = col_order[self.csr.indices.long()].long()
            k = torch.clamp(r * b // max(n, 1), max=b - 1)
            l = torch.clamp(c * b // max(m, 1), max=b - 1)
            grid = torch.zeros((b, b), dtype=torch.float64, device=r.device)
            grid.index_put_((k, l), self.csr.vals.abs().to(torch.float64), accumulate=True)
        return grid.cpu().numpy(), stats

    def _section(self, name, grid, stats, extra_features: Dict) -> str:
        feats = {
            "max block bandwidth": stats["max_bw"],
            "mean block bandwidth": round(float(stats["mean_bw"]), 2),
            "full blocks": stats["num_full_blocks"],
            "block mean bandwidth": round(float(stats["block_mean_bw"]), 2),
            **extra_features,
        }
        items = "".join(f"<li>{k}: {v}</li>" for k, v in feats.items())
        row_nnz = grid.sum(axis=1)
        return (
            '<div class="section">'
            '<div class="left-section">'
            f"<h2>{name}</h2>{_spy_svg(grid)}</div>"
            '<div class="middle-section"><div class="feature-box">'
            f"<h3>Ordering Based Features</h3><ul>{items}</ul></div></div>"
            '<div class="right-section"><div class="graphical-box">'
            "<h3>Graphical Features</h3>"
            + _histogram_svg(row_nnz, caption="nnz per row block")
            + "</div></div></div>"
        )

    def to_html(self) -> str:
        n, m = self.csr.shape
        ident = torch.arange(n, dtype=self.csr.indices.dtype, device=self.csr.indices.device)
        ident_c = torch.arange(m, dtype=ident.dtype, device=ident.device)
        sections = [
            self._section("natural ordering", *self._density(ident, ident_c), {})
        ]
        for name, (ro, co, extra) in self._orderings.items():
            sections.append(self._section(name, *self._density(ro, co), extra))
        cards = "".join(
            f'<div class="card"><h3>{k}</h3><p>{v}</p></div>'
            for k, v in self._features.items()
        )
        cards_html = (
            f'<div class="non-ordering-based-features">{cards}</div>'
            if cards
            else ""
        )
        return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1.0">
<title>{self.title}</title>
<style>{_CSS}</style></head><body>
<div class="header"><h1>{self.name}</h1>
<p>shape {n}&times;{m}, nnz {self.csr.nnz}, {self.num_parts}&times;{self.num_parts} buckets</p></div>
<div class="content">
{cards_html}
{''.join(sections)}
</div></body></html>"""

    def write_html(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_html())


def _report(csr: CSR, name: str, orderings: Sequence[str], num_parts: int = 64,
            plot_edges_by_weights: bool = False) -> Visualizer:
    """The CLI's dashboard of ``csr``: cards of its degrees and natural
    bandwidth and profile, and a section per ``ReorderBase`` alias in
    ``orderings`` listing the permuted matrix's bandwidth and profile."""
    from ..bases import ReorderBase
    from ..ops.feature import AvgDegree, Bandwidth, MaxDegree, MinDegree, MinMaxAvgDegree, Profile

    viz = Visualizer(csr, num_parts=num_parts, title=name, name=name,
                     plot_edges_by_weights=plot_edges_by_weights)
    mma = MinMaxAvgDegree().execute(None, csr)
    viz.add_features({
        "min degree": int(mma[MinDegree]),
        "max degree": int(mma[MaxDegree]),
        "avg degree": round(float(mma[AvgDegree]), 2),
        "bandwidth (natural)": int(Bandwidth().execute(None, csr)),
        "profile (natural)": int(Profile().execute(None, csr)),
    })
    for alias in orderings:
        order = ReorderBase.reorder(alias, csr)
        perm = ReorderBase.permute2d(order, csr)
        viz.add_ordering(alias, order, features={
            "bandwidth": int(Bandwidth().execute(None, perm)),
            "profile": int(Profile().execute(None, perm)),
        })
    return viz


def _cli(argv: Sequence[str]) -> int:
    import argparse
    import contextlib
    import os

    ap = argparse.ArgumentParser(
        prog="python -m sparsebase_tpu_torch.utils.visualizer",
        description="Render the multi-ordering HTML dashboard for a matrix.",
    )
    ap.add_argument("matrix", help=".mtx file")
    ap.add_argument("output", help="output .html path")
    ap.add_argument("--orderings", default="rcm,degree",
                    help="comma-separated reorderer names (ReorderBase aliases)")
    ap.add_argument("--parts", type=int, default=64, help="heatmap buckets")
    ap.add_argument("--weights", action="store_true",
                    help="bucket |values| instead of nnz counts")
    ap.add_argument("--trace", default=None,
                    help="also write a torch.profiler Chrome trace under this dir")
    ap.add_argument("--device", default="cuda",
                    help="where the matrix is read and the dashboard computed (default cuda)")
    args = ap.parse_args(argv)

    from ..bases import IOBase
    from ..experiment import trace_to

    traced = trace_to(args.trace, "visualizer") if args.trace else contextlib.nullcontext()
    with traced:
        csr = IOBase.read_mtx_to_csr(args.matrix, device=args.device)
        name = os.path.basename(args.matrix)
        viz = _report(csr, name, [a for a in args.orderings.split(",") if a], args.parts, args.weights)
        viz.write_html(args.output)
    if args.trace:
        print(f"wrote {args.output} + trace under {args.trace}")
    else:
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI test
    import sys

    raise SystemExit(_cli(sys.argv[1:]))
