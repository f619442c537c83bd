"""``correct`` comes out false for the lower-precision control and for
each fault a cell can have, at sizes a CPU test holds.

The control is the plain reference put in the program's place and
computed in bfloat16 (``perfbench/readings.py`` reads it on the card at
the cells' own sizes).  The faults are planted in the program's timed
path underneath a whole run (``rehearse.py``): a step that returns its
state unchanged, half of the catalog left out with the mean taken over
the rest, the fit's parameters altered where each step makes them, a
fit started a little away from its own guess, and (where fits are
batched) two rows of a batch answered with each other's trajectories.
The exchange between chips has no fault here: every cell runs on one
card, in one process, with no collective on its path."""
import os

import pytest

from perfbench.core.compare import judge, sample
from perfbench.core.registry import Benchmark
from perfbench.readings import stand_in_fits
from perfbench.tests.rehearse import rehearsal
from perfbench.tests.test_perfbench_rehearsal import CELLS, rehearse

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["control", "half"])
def test_stand_in_is_not_correct(cell, kind):
    bench = Benchmark(REPO)
    model, _ = rehearsal(bench, cell)
    fits, reference, traffic = stand_in_fits(
        bench, bench.cell(cell), 2_100_000_003, kind, "cpu", model.SIZES)
    correct, checks = judge(fits, reference,
                            float(traffic["learning_rate"]),
                            bench.limits(cell), len(fits), 5)
    assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "moved"])
def test_fault_is_not_correct(cell, fault):
    result, modules = rehearse(cell, 2_200_000_023, fault=fault)
    assert result["correct"] is False, result["checks"]
    assert modules["forbidden_modules"] == []
    if fault == "moved":
        assert result["checks"]["start_gap"]["value"] > 0


def test_swapped_rows_are_not_correct():
    """Two rows of a served batch swapped: every fit keeps a trajectory
    that is sound from its own start, and the start gives it away."""
    result, _ = rehearse("smf_1e8.serve16", 2_200_000_037, fault="swapped")
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["start_gap"]["value"] > 0


def test_sample_holds_the_last_dispatch_whole():
    fits = list(range(40))
    picked = sample(fits, 20, 7, last=16)
    assert len(picked) == 20 and picked[-16:] == fits[-16:]
    assert picked == sample(fits, 20, 7, last=16)
    assert sample(fits[:3], 20, 7, last=16) == fits[:3]
    assert sample([], 4, 7) == []


def test_faults_leave_the_rehearsal_sound():
    """The same rehearsal without a fault is correct (the faults above
    are what fails it)."""
    result, _ = rehearse(CELLS[0], 2_200_000_023)
    assert result["correct"] is True, result["checks"]
