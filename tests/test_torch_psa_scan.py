"""The port's row-scan oracle (tsta_tpu_torch.ops.psa_scan) against the
JAX oracle (tsta_tpu.ops.psa_scan) on the CPU: int32 scores and corners
and the three int8 traceback planes, with zero tolerance."""

import os

import jax
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams
from tsta_tpu.io import encode_dna, read_first_record
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu_torch.ops import psa_scan as tscan

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PSA_CASES = ["psa_small%d" % k for k in range(1, 8)]


def golden_params(case_dir: str) -> AlignParams:
    """AlignParams from a golden case's params.txt (reference flags)."""
    with open(os.path.join(case_dir, "params.txt")) as f:
        toks = f.read().split()
    names = {"-M": "match", "-X": "mismatch", "-E": "gap_extend",
             "-O": "gap_open"}
    kw = {names[toks[k]]: int(toks[k + 1]) for k in range(0, len(toks), 2)}
    return AlignParams(**kw)


def golden_pair(case_dir: str):
    """Encoded (a, b) of a golden case, longer sequence horizontal."""
    s1 = read_first_record(os.path.join(case_dir, "a.fa")).sequence
    s2 = read_first_record(os.path.join(case_dir, "b.fa")).sequence
    if len(s2) > len(s1):
        s1, s2 = s2, s1
    return encode_dna(s1), encode_dna(s2)


def _assert_same(a, b, params, traced):
    j = jscan.psa_align(a, b, params, traced=traced)
    t = tscan.psa_align(a, b, params, traced=traced, device="cpu")
    assert (t.score, t.last) == (int(j.score), int(j.last))
    if traced:
        for name in ("back", "fback", "eback"):
            want = np.asarray(getattr(j, name))
            got = getattr(t, name).numpy()
            assert got.dtype == np.int8 and got.shape == want.shape
            assert np.array_equal(got, want), name


@pytest.mark.parametrize("case", PSA_CASES)
def test_oracle_matches_jax_on_goldens(case):
    d = os.path.join(GOLDEN, case)
    a, b = golden_pair(d)
    _assert_same(a, b, golden_params(d), traced=True)


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


@pytest.mark.parametrize("params", [
    (2, -5, -2, -4), (1, -1, -1, 0), (5, -4, -1, -6), (24, -24, -24, -24),
    # outside the packed kernels' gate: no padding, exact all the same
    (0, -1, -1, -1), (-1, -2, -1, -2), (2, 1, -1, -3), (3, -2, 1, -2),
])
def test_oracle_matches_jax_fuzz(params):
    rng = np.random.default_rng(sum(abs(v) for v in params) + 101)
    for _ in range(3):
        n = int(rng.integers(1, 160))
        m = int(rng.integers(1, 160))
        a = _rnd(rng, n)
        if rng.random() < 0.5:   # similar pair: long diagonal and gap runs
            b = np.delete(a, rng.integers(0, n, n // 6))
            b = b if len(b) else a[:1]
        else:
            b = _rnd(rng, m)
        _assert_same(a, b, params, traced=True)


def test_score_only_matches_traced():
    rng = np.random.default_rng(7)
    a, b = _rnd(rng, 333), _rnd(rng, 290)
    s = tscan.psa_align(a, b, (2, -5, -2, -4), device="cpu")
    t = tscan.psa_align(a, b, (2, -5, -2, -4), traced=True, device="cpu")
    assert (s.score, s.last) == (t.score, t.last)
    assert s.back is None


def test_oracle_errors_match_jax():
    a = np.frombuffer(b"ACGT", np.uint8)
    empty = np.zeros(0, np.uint8)
    for args in ((a, a, (2, -5, -2, 1)), (a, empty, (2, -5, -2, -4)),
                 (empty, a, (2, -5, -2, -4))):
        with pytest.raises(ValueError):
            jscan.psa_align(*args)
        with pytest.raises(ValueError):
            tscan.psa_align(*args, device="cpu")


def test_bucket_and_pads_match_jax():
    assert (tscan.A_PAD, tscan.B_PAD) == (jscan.A_PAD, jscan.B_PAD)
    for n in (1, 127, 128, 129, 2047, 2048, 2049, 10000, 40000):
        assert tscan.bucket(n) == jscan.bucket(n)
    assert tscan.NEG == int(jscan.NEG)


def test_scan_rows_batch_equals_single_pairs():
    """The batched core over a padded shape gives each pair the same
    score, corner and codes as its own run."""
    rng = np.random.default_rng(9)
    ns, ms = [200, 150, 37], [180, 200, 90]
    n, m = 256, 256
    a = np.zeros((3, n), np.uint8)
    b = np.ones((3, m), np.uint8)
    for k in range(3):
        a[k, :ns[k]] = _rnd(rng, ns[k])
        b[k, :ms[k]] = _rnd(rng, ms[k])
    best, corner, codes = tscan.scan_rows(
        torch.from_numpy(a), torch.from_numpy(b), torch.tensor(ns),
        torch.tensor(ms), (2, -5, -2, -4), traced=True)
    for k in range(3):
        j = jscan.psa_align(a[k, :ns[k]], b[k, :ms[k]], (2, -5, -2, -4),
                            traced=True)
        assert (int(best[k]), int(corner[k])) == (int(j.score), int(j.last))
        back, fback, eback = tscan.planes_from_codes(
            codes[k, :ms[k], :ns[k]])
        assert np.array_equal(back.numpy(), np.asarray(j.back))
        assert np.array_equal(fback.numpy(), np.asarray(j.fback))
        assert np.array_equal(eback.numpy(), np.asarray(j.eback))


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
