"""The comparison that decides ``correct``, on the CPU at a size a test run
holds: the program passes, the control (the reference in bfloat16 in the
program's place) fails, and so does each fault planted under the timed path
(benchmark/faults.py).  The limits are the real cells' (benchmark/cells/)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from benchmark.faults import FAULTS
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_is_correct(copy, cell):
    line = tiny.run(copy, cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(copy, cell):
    assert not tiny.run(copy, cell, control=True)["correct"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(tiny.CELLS)
                                        for f in FAULTS[c.split(".", 1)[0]]])
def test_fault_is_not_correct(copy, cell, fault):
    line = tiny.run(copy, cell, fault=fault)
    assert not line["correct"], line["checks"]


def test_no_card_prints_no_result(copy):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "viewer.tiny",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=copy,
                         env=dict(os.environ, PYTHONPATH=str(tiny.REPO)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_without_the_port_prints_no_result(copy):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, torch; from benchmark import harness, run; sys.exit(run.execute("
            "run.parse(['--workload', 'viewer.tiny', '--seed', '3', '--seconds', '0.5', "
            "'--trace', '0']), harness.spec(), torch.device('cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cells_on_the_card(copy, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    line = tiny.run(copy, cell, device="cuda", trace=1)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
