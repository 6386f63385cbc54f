"""Each cell through the harness on a CUDA card, cut to a test's size: the
untraced run reports its end-to-end metrics, the traced run its per-layer
metrics and the device's busy share, and both are correct. Skips without
a card."""

import time

import pytest

from benchmark.core import harness

CELLS = ("kron.preprocess", "hpcg.dia_solve", "hpcg.preprocess", "kron.partition")
SMALL = {"gap-kron-s25": {"scale": 16}, "hpcg-27pt-256": {"nx": 32, "ny": 32, "nz": 32}}


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_on_the_card(card, spec, workload):
    over = SMALL[spec.cell(workload)["config"]]
    line = harness.run(workload, 2**31 + 3, 0.5, False, process_start=time.perf_counter(), dev=card, spec=spec,
                       overrides=over)
    assert line["correct"], line["checks"]
    assert {m["name"] for m in spec.end_to_end(workload)} <= set(line["metrics"])
    traced = harness.run(workload, 2**31 + 4, 0.5, True, process_start=time.perf_counter(), dev=card, spec=spec,
                         overrides=over, margin_s=0.2)
    assert traced["correct"], traced["checks"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert {m["name"] for m in spec.per_layer(workload)} == set(traced["metrics"])
    for name, m in traced["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105, (name, m)
