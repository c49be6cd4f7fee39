"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
checkout's root.  Tests marked ``cuda`` need the card and skip without
it; the rest run on the CPU at tiny sizes."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at sizes a CPU test holds: the same kinds, smaller mixes
TINY = {
    "psa_affine.batch128_score": {"pairs": 6, "length": 300, "batches": 2,
                                  "example_slot0": False, "sample_pairs": 4},
    "psa_affine.pair200k_traced": {"length": 900, "pairs": 2},
    "msa_poa.reads3x50k": {"length": 700, "sets": 2},
    "msa_poa.reads3x200k": {"length": 600, "sets": 2},
}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
