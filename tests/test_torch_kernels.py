"""The CUDA kernels of tsta_tpu_torch against their plain PyTorch
versions on the card, with exact integer equality.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (this file imports no jax, so it also runs on a host without it):

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan
from tsta_tpu_torch.ops import traceback as tb

P0 = (2, -5, -2, -4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(seed, lengths, m_quantum=1, n_quantum=1, similar=False):
    rng = np.random.default_rng(seed)
    ns = [n for n, _ in lengths]
    ms = [m for _, m in lengths]
    n_pad = -(-max(ns) // n_quantum) * n_quantum
    m_pad = -(-max(ms) // m_quantum) * m_quantum
    a = np.full((len(ns), n_pad), psa_scan.A_PAD, np.uint8)
    b = np.full((len(ns), m_pad), psa_scan.B_PAD, np.uint8)
    for k, (n, m) in enumerate(lengths):
        a[k, :n] = rng.integers(65, 69, n)
        if similar:
            src = np.delete(a[k, :n], rng.integers(0, n, max(1, n // 15)))
            src = np.concatenate([src, rng.integers(65, 69, m)])[:m]
            src[rng.integers(0, m, max(1, m // 20))] = 65
            b[k, :m] = src
        else:
            b[k, :m] = rng.integers(65, 69, m)
    lens = np.array([ns, ms], np.int32).T.copy()
    return (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lens))


@pytest.mark.cuda
@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6), (1, -1, -1, 0)])
def test_dp_score_kernel_matches_plain(cuda, params):
    a, b, lens = _batch(1, [(1, 1), (7, 300), (300, 7), (1000, 950),
                            (513, 700), (2100, 1800)], 256, 128)
    want = psa_diff.dp_packed(a, b, lens, params)
    n0 = _kernels.launches["psa_dp_score"]
    got = psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens.to(cuda), params)
    torch.cuda.synchronize()
    assert _kernels.launches["psa_dp_score"] == n0 + 1
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("similar", [False, True])
def test_dp_traced_kernel_and_walk_match_plain(cuda, similar):
    a, b, lens = _batch(2, [(512, 500), (400, 512), (130, 60), (9, 8)],
                        256, 512, similar=similar)
    ws, wc, wplane = psa_diff.dp_packed(a, b, lens, P0, traced=True)
    gs, gc, gplane = psa_diff.dp_packed(a.to(cuda), b.to(cuda),
                                        lens.to(cuda), P0, traced=True)
    torch.cuda.synchronize()
    assert torch.equal(gs.cpu(), ws) and torch.equal(gc.cpu(), wc)
    assert torch.equal(gplane.cpu(), wplane)
    n0 = _kernels.launches["psa_walk"]
    gw, gcnt = tb.walk_packed(gplane, lens.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.launches["psa_walk"] == n0 + 1
    pw, pcnt = tb.walk_packed_plain(wplane, lens)
    assert torch.equal(gcnt.cpu(), pcnt) and torch.equal(gw.cpu(), pw)


@pytest.mark.cuda
def test_traced_batch_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(65, 69, n).astype(np.uint8),
              rng.integers(65, 69, m).astype(np.uint8))
             for n, m in [(600, 580), (300, 200), (50, 50)]]
    want = psa_diff.psa_align_batch_traced_packed(pairs, P0, device="cpu")
    got = psa_diff.psa_align_batch_traced_packed(pairs, P0, device=cuda)
    assert got == want


@pytest.mark.cuda
def test_wrappers_refuse_bad_tensors(cuda):
    a, b, lens = _batch(3, [(100, 90)], 256, 128)
    with pytest.raises(ValueError):
        psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens, P0)
    with pytest.raises(ValueError):
        psa_diff.dp_packed(a.to(cuda), b.to(cuda), lens.to(cuda).long(), P0)
    plane = torch.zeros((1, 256, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tb.walk_packed(plane[:, :, :64], lens.to(cuda))
