"""The port's packed DP path (tsta_tpu_torch.ops.psa_diff, plain version
on the CPU) against the JAX packed kernels in interpret mode: scores,
corners, every traceback cell code (through convert.plane_from_jax) and
the decoded alignments, with zero tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import psa_diff as jdiff
from tsta_tpu.ops import psa_pallas as jpallas
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu_torch import convert, device
from tsta_tpu_torch.ops import psa_chunked
from tsta_tpu_torch.ops import psa_diff as tdiff
from tsta_tpu_torch.ops import psa_pallas as tpallas

P0 = (2, -5, -2, -4)


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


@pytest.mark.parametrize("params", [P0, (1, -1, -1, 0), (5, -4, -1, -6),
                                    (3, -2, -11, -46)])
def test_score_batch_matches_jax(params):
    rng = np.random.default_rng(sum(abs(v) for v in params))
    pairs = [(_rnd(rng, int(rng.integers(5, 700))),
              _rnd(rng, int(rng.integers(5, 700)))) for _ in range(5)]
    js, jc = jdiff.psa_align_batch_diff(pairs, params)
    ts, tc = tdiff.psa_align_batch_diff(pairs, params, device="cpu")
    assert ts.dtype == np.int32 and tc.dtype == np.int32
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))


def _similar(rng, n, dels, ins):
    a = _rnd(rng, n)
    b = np.delete(a, rng.integers(0, n, dels))
    b = np.insert(b, rng.integers(0, len(b), ins), _rnd(rng, ins))
    return (a, b) if len(a) >= len(b) else (b, a)


def _traced_cases():
    rng = np.random.default_rng(17)
    mixed = []
    for _ in range(4):
        n = int(rng.integers(40, 500))
        mixed.append((_rnd(rng, n), _rnd(rng, int(rng.integers(30, n + 1)))))
    gaps = [_similar(rng, int(rng.integers(200, 400)), 30, 15)
            for _ in range(3)]
    tiny = [(np.frombuffer(b"A", np.uint8), np.frombuffer(b"A", np.uint8)),
            (np.frombuffer(b"ACGT", np.uint8), np.frombuffer(b"T", np.uint8)),
            (_rnd(rng, 7), _rnd(rng, 7)), (_rnd(rng, 9), _rnd(rng, 8))]
    unswapped = [(_rnd(rng, 150), _rnd(rng, 400))]
    return {"mixed": mixed, "gap_runs": gaps, "tiny": tiny,
            "unswapped": unswapped}


@pytest.mark.parametrize("name", ["mixed", "gap_runs", "tiny", "unswapped"])
def test_traced_batch_matches_jax(name):
    pairs = _traced_cases()[name]
    want = jdiff.psa_align_batch_traced_packed(pairs, P0)
    got = tdiff.psa_align_batch_traced_packed(pairs, P0, device="cpu")
    assert got == want


def _group(pairs):
    """One traced group laid out for both packages."""
    P = len(pairs)
    n_real = [len(a) for a, _ in pairs]
    m_real = [len(b) for _, b in pairs]
    n_pad = max(jdiff._traced_n_pad(n) for n in n_real)
    m_pad = -(-max(m_real) // jdiff.T_R) * jdiff.T_R
    Rp = n_pad // jdiff.LANES
    a = np.full((P, n_pad), jdiff.A_PAD, np.uint8)
    b = np.full((P, m_pad), jdiff.B_PAD, np.uint8)
    for k, (x, y) in enumerate(pairs):
        a[k, :len(x)] = x
        b[k, :len(y)] = y
    nm = np.array([n_real, m_real], np.int32).T.copy()
    return a, b, nm, n_pad, m_pad, Rp


@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6)])
def test_traced_plane_matches_jax_every_cell(params):
    """The port's plain traced DP writes the same code as the JAX
    kernel in every cell of the group, padding included."""
    rng = np.random.default_rng(23 + params[0])
    pairs = [_similar(rng, 500, 40, 20), (_rnd(rng, 480), _rnd(rng, 300)),
             (_rnd(rng, 130), _rnd(rng, 90))]
    a, b, nm, n_pad, m_pad, Rp = _group(pairs)
    P = len(pairs)
    js, jc, jplane = jdiff._psa_diff_traced_call(
        jnp.asarray(a.reshape(P * Rp, jdiff.LANES).astype(np.int32)),
        jnp.asarray(b.T.astype(np.int32)), jnp.asarray(nm),
        n_pad, m_pad, P, params)
    ts, tc, tplane = tdiff.dp_packed(torch.from_numpy(a),
                                     torch.from_numpy(b),
                                     torch.from_numpy(nm), params,
                                     traced=True)
    assert np.array_equal(ts.numpy(), np.asarray(js)[0])
    assert np.array_equal(tc.numpy(), np.asarray(jc)[0])
    assert tplane.shape == (P, m_pad, n_pad)
    assert torch.equal(tplane, convert.plane_from_jax(jplane, P))
    assert np.array_equal(convert.plane_to_jax(tplane), np.asarray(jplane))


def test_plane_conversion_round_trip():
    rng = np.random.default_rng(3)
    plane = torch.from_numpy(rng.integers(0, 27, (3, 8, 256),
                                          dtype=np.uint8))
    words = convert.plane_to_jax(plane)
    assert words.shape == (2, 6, 128) and words.dtype == np.int32
    assert torch.equal(convert.plane_from_jax(words, 3), plane)
    # byte k of word w holds row 4w + k
    assert (words[1, 2, 5] >> 16) & 0xFF == plane[1, 6, 5]
    with pytest.raises(ValueError):
        convert.plane_from_jax(words, 4)
    with pytest.raises(ValueError):
        convert.plane_to_jax(plane[:, :7])


def test_params_from_jax():
    from tsta_tpu.config import AlignParams
    assert convert.params_from_jax(AlignParams()) == P0
    assert convert.params_from_jax((1, -1, -1, 0)) == (1, -1, -1, 0)
    with pytest.raises(ValueError):
        convert.params_from_jax((1, 2, 3))


def test_gates_match_jax():
    for p in [P0, (24, -24, -24, -24), (100, -100, -60, -60),
              (2, -5, -2, 4), (2, -5, 2, -4), (0, -5, -2, -4),
              (2, 0, -2, -4), (1, -1, -1, 0)]:
        assert tdiff.supports_params(p) == jdiff.supports_params(p), p
    for n in (1, 100, 128, 129, 400, 500, 512, 1000, 4000, 10000, 10240):
        assert tdiff._traced_n_pad(n) == jdiff._traced_n_pad(n), n
    assert (tdiff.LANES, tdiff.T_R) == (jdiff.LANES, jdiff.T_R)


def test_score_router_matches_jax():
    """The score router (``ops/psa_pallas.py``, as in the JAX package)."""
    rng = np.random.default_rng(11)
    pairs = [(_rnd(rng, 300), _rnd(rng, 280)) for _ in range(3)]
    js, jc = jpallas.psa_align_batch(pairs, P0)
    ts, tc = tpallas.psa_align_batch(pairs, P0, device="cpu")
    assert np.array_equal(ts, np.asarray(js))
    assert np.array_equal(tc, np.asarray(jc))
    # M <= 0: outside the packed gate, the round-1 kernels' plain versions
    for params in [(0, -1, -1, -1), (-1, -2, -1, -2)]:
        ts, tc = tpallas.psa_align_batch(pairs[:2], params, device="cpu")
        for (a, b), s, c in zip(pairs, ts, tc):
            j = jscan.psa_align(a, b, params)
            assert (int(s), int(c)) == (int(j.score), int(j.last))
    with pytest.raises(ValueError):
        tpallas.psa_align_batch(pairs, (2, 1, -1, -3), device="cpu")


@pytest.mark.parametrize("params", [P0, (0, -1, -1, -1)])
def test_traced_router_matches_jax(params):
    """The traced router (``ops/psa_pallas.py``, as in the JAX package)."""
    rng = np.random.default_rng(41)
    a, b = _similar(rng, 260, 20, 10)
    want = jpallas.psa_align_traced_device(a, b, params)
    got = tpallas.psa_align_traced_device(a, b, params, device="cpu")
    assert got == want
    with pytest.raises(ValueError):
        tpallas.psa_align_traced_device(a, b, (2, 1, -1, -3), device="cpu")


def test_unported_options_raise():
    a = np.frombuffer(b"ACGTAC", np.uint8)
    # a mesh shares the batch over its data axis: the meshless values
    from tsta_tpu_torch.parallel import mesh as tmeshlib
    mesh = tmeshlib.make_mesh(2, 1, devices=["cpu"] * 2)
    b = np.frombuffer(b"ACGTTAC", np.uint8)
    pairs = [(a, a), (b, a), (a, b)]
    for got, want in zip(
            tdiff.psa_align_batch_diff(pairs, P0, mesh=mesh),
            tdiff.psa_align_batch_diff(pairs, P0, device="cpu")):
        assert np.array_equal(got, want)
    assert (tdiff.psa_align_batch_traced_packed(pairs[:2], P0, mesh=mesh)
            == tdiff.psa_align_batch_traced_packed(pairs[:2], P0,
                                                   device="cpu"))
    with pytest.raises(ValueError):
        tdiff.psa_align_batch_diff([(a, a)], (2, -5, -2, 4), device="cpu")
    with pytest.raises(ValueError):
        tdiff.psa_align_batch_diff([], P0, device="cpu")
    with pytest.raises(ValueError):
        tdiff.psa_align_batch_diff([(a, a[:0])], P0, device="cpu")


def test_traced_groups_follow_budget(monkeypatch):
    """Groups share a padded width and stay inside the budget (2 * P *
    m_pad * n_pad bytes, the JAX rule); a pair past it alone goes to the
    chunked path, and the batch gives JAX's results either way."""
    n = [500, 480, 130, 500, 1000]
    m = [500, 300, 90, 260, 900]
    groups, chunked = tdiff._traced_groups(n, m, budget=8 * 512 * 512)
    assert chunked == []
    assert sorted(i for g in groups for i in g) == list(range(5))
    for g in groups:
        assert len({tdiff._traced_n_pad(n[i]) for i in g}) == 1
        m_pad = -(-max(m[i] for i in g) // 256) * 256
        assert (2 * len(g) * m_pad * tdiff._traced_n_pad(n[g[0]])
                <= 8 * 512 ** 2)
    assert [len(g) for g in groups] == [1, 3, 1]
    groups, chunked = tdiff._traced_groups(n, m, budget=4 * 512 * 512)
    assert chunked == [4] and [len(g) for g in groups] == [2, 1, 1]
    rng = np.random.default_rng(2)
    pairs = [(_rnd(rng, 600), _rnd(rng, 500)), (_rnd(rng, 300), _rnd(rng, 200))]
    want = jdiff.psa_align_batch_traced_packed(pairs, P0)
    for budget, routed in ((2 * 640 * 512 - 1, True), (2 * 640 * 512, False)):
        monkeypatch.setattr(device, "CPU_BUDGET", budget)
        psa_chunked.last_clock = None
        got = tdiff.psa_align_batch_traced_packed(pairs, P0, device="cpu")
        assert got == want
        assert (psa_chunked.last_clock is not None) == routed


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = np.frombuffer(b"ACGTAC", np.uint8)
    from tsta_tpu_torch.device import DeviceError
    with pytest.raises(DeviceError):
        tdiff.psa_align_batch_diff([(a, a)], P0, device="cuda")
    with pytest.raises(DeviceError):
        tdiff.psa_align_batch_traced_packed([(a, a)], P0)
