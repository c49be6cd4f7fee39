"""The control of each cell's check (``portbench/control.py``): the plain
reference in a narrower integer type, in the program's place, has to come
out not correct.  At the cells' own sizes on the card; the 8-bit control
also at a CPU size, where 8 bits already overflow."""

import pytest
import torch

from conftest import TINY
from portbench import control


def failed(checks):
    return any(v > lim for _, v, lim in checks)


def test_int8_control_fails_at_a_cpu_size():
    checks = control.control("psa_affine.batch128_score", 2 ** 31 + 1,
                             torch.device("cpu"),
                             TINY["psa_affine.batch128_score"])
    assert failed(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_at_the_cells_size(cuda, workload):
    checks = control.control(workload, 2 ** 31 + 1, cuda)
    assert failed(checks), checks
