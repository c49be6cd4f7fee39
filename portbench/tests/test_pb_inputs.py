"""Each cell's inputs repeat from their seed, and differ across seeds."""

import pytest

from conftest import TINY
from portbench import harness

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("workload", sorted(TINY))
def test_inputs_repeat_from_the_seed(workload):
    cell = harness.cell(workload)
    mix = cell["mix"] if "200k" not in workload else {**cell["mix"],
                                                      "length": 20000}
    kind = cell["kind"]
    one, two = kind.inputs(mix, BIG), kind.inputs(mix, BIG)
    assert one == two
    assert kind.inputs(mix, BIG + 99) != one


def test_batch_sizes_are_fixed_and_slot0_is_the_example():
    from portbench.traffic import seeded
    cell = harness.cell("psa_affine.batch128_score")
    batches = cell["kind"].inputs(cell["mix"], 7)
    assert len(batches) == cell["mix"]["batches"]
    for b in batches:
        assert len(b) == 128 and b[0] == seeded.example_pair()
        assert {(len(x), len(y)) for x, y in b[1:]} == {(10240, 10240)}


def test_read_sets_have_nearly_the_same_sizes_on_every_seed():
    """The deletions are drawn with repeats, so a copy keeps a few more
    bases than length - length // 50: within 0.1% on every seed."""
    from portbench.traffic import seeded
    for seed in (1, 2 ** 31 + 5, 10 ** 12):
        base, *copies = (len(r) for r in seeded.long_reads(seed, 50000))
        assert base == 50000
        assert all(49000 <= c <= 49050 for c in copies)
