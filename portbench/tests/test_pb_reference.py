"""The plain references: the example's known answers, and agreement with
the program's own plain route on small inputs."""

import ast
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.reference import gotoh, poa
from portbench.traffic import seeded

PARAMS = (2, -5, -2, -4)


def test_example_pair_maxsorce_is_minus_5():
    best, _ = gotoh.score_pairs([seeded.example_pair()], PARAMS, "cpu")
    assert best == [-5]


def test_example_msa_round_scores():
    out = poa.align_seqs(seeded.example_msa_reads(), PARAMS, "cpu")
    assert out["round_scores"] == [-5451, -3101, -1776, -870]
    assert [r.replace(b"-", b"") for r in out["rows"]] == \
        seeded.example_msa_reads()


def test_rescore_counts_each_gap_run_once():
    assert gotoh.rescore(b"AC--GT", b"ACTTGA", PARAMS) == \
        2 + 2 + (-4 - 2 * 2) + 2 - 5
    assert gotoh.rescore(b"A-C", b"AG-", PARAMS) == 2 + (-6) + (-6)
    with pytest.raises(ValueError):
        gotoh.rescore(b"A-", b"A-", PARAMS)


def test_gotoh_matches_the_program_on_random_pairs():
    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.parallel import batch
    rng = np.random.default_rng(11)
    lens = [(int(rng.integers(20, 300)), int(rng.integers(20, 300)))
            for _ in range(10)]
    pairs = seeded.random_pairs(rng, lens, lambda k: k % 2 == 0)
    got = batch.align_batch(pairs, AlignParams(), device="cpu")
    best, corner = gotoh.score_pairs(pairs, PARAMS, "cpu")
    assert [r.score for r in got] == best and [r.last for r in got] == corner


@pytest.mark.parametrize("seed", [3, 4])
def test_poa_matches_the_program(seed):
    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.ops import msa_native
    seqs = seeded.long_reads(seed, 600)
    want = msa_native.align_seqs(seqs, AlignParams(), device="cpu")
    got = poa.align_seqs(seqs, PARAMS, "cpu")
    assert got["rows"] == want.rows and got["consensus"] == want.consensus
    assert got["round_scores"] == want.round_scores


def test_poa_segments_equal_the_whole_plane():
    seqs = seeded.long_reads(9, 500)
    whole = poa.align_seqs(seqs, PARAMS, "cpu")
    for rows in (1, 37, 300):
        assert poa.align_seqs(seqs, PARAMS, "cpu",
                              budget=500 * 4 * rows) == whole


def test_narrow_dtypes_saturate():
    pair = [seeded.random_pairs(np.random.default_rng(1), [(400, 400)],
                                lambda k: True)[0]]
    best32, _ = gotoh.score_pairs(pair, PARAMS, "cpu")
    best8, _ = gotoh.score_pairs(pair, PARAMS, "cpu", torch.int8)
    assert best32[0] > 127 and best8 == [127]


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            tops = {m.split(".")[0] for m in imports(os.path.join(ref, fn))}
            assert not tops & {"tsta_tpu_torch", "tsta_tpu", "jax"}, fn


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for fn in files:
            if fn.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in imports(os.path.join(dirpath, fn))}
                assert not tops & {"tsta_tpu", "jax", "jaxlib", "flax"}, fn
