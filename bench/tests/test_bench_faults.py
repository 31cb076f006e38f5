"""``correct`` against faults: a whole run of each cell at a CPU size with
the program broken underneath (``bench/harness/faults.py``), judged under
the cell's own limits; and the sound program, which passes them.  The
float8 control, put in the program's place, is not correct either."""

from __future__ import annotations

import pytest

from bench.harness import cell as runner, check, control
from bench.harness.faults import FAULTS, Api

from ._tiny import CELLS, tiny

SEED = 2**34 + 5


def _run(name, fault):
    c = tiny(name)
    c.traffic["warmup_calls"] = 0
    return runner.run(c, SEED, 0.0, False, "cpu", steps=4, api=Api(fault))


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    line, _run_, readings = _run(name, "none")
    assert line["correct"], line["check"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    line, _run_, _readings = _run(name, fault)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = tiny(name)
    _line, run, _readings = runner.run(c, SEED, 0.0, False, "cpu", steps=4)
    readings = control.readings(c, run.sample["params"], run.sample)
    ok, table = check.verdict({**readings, **({"kept_wrong": 0} if c.dims.experts else {})},
                              c.check["limits"])
    assert not ok, table
