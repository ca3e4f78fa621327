"""The check's control on the card, at each cell's own size: the plain
reference in TF32 put in the program's place has to come out as not
correct.  ``python -m pytest -q -m cuda portbench/tests`` on a machine with
the card; here it skips."""
from __future__ import annotations

import pytest

# the numbers by which the control fails, a cell
CAUGHT_BY = {"covtype-cluster": {"eigval_rel", "subspace_sin"},
             "msd-fit-pcg": {"cols_rel"}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CAUGHT_BY))
def test_tf32_control_is_not_correct(cuda_device, cell):
    from portbench import control

    for r in control.readings(cell, [2**33 + 101], cuda_device):
        assert r["correct"] is False
        over = {n for n, v in r["numbers"].items() if v > r["limits"][n]}
        assert over & CAUGHT_BY[cell], r
