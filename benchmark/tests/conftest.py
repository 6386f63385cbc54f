"""The benchmark's own tests, on the CPU at tiny sizes.

    python -m pytest benchmark/tests -q

Tests that need a CUDA card take the ``card`` fixture, which skips them,
with a reason, where torch sees none; the check runs in the test, not when
the module is imported. On a card they run with the same command.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {  # each configuration cut to a size a test run holds
    "gap-kron-s25": {"scale": 10},
    "hpcg-27pt-256": {"nx": 8, "ny": 8, "nz": 8},
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def spec():
    from benchmark.core.spec import Spec

    return Spec(ROOT)


@pytest.fixture
def tiny(spec):
    """``overrides(workload)``: the cut that makes the cell's configuration tiny."""
    return lambda workload: TINY[spec.cell(workload)["config"]]
