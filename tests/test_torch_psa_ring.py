"""The port's ring wavefront and column-sharded PSA against the JAX package.

``ops.psa_ring.align_long_ring`` and ``parallel.longseq.align_long`` on
CPU meshes (``parallel.mesh.make_mesh`` over repeated ``cpu`` devices run
the plain schedule ``psa_ring.ring_plain``) against JAX's scan oracle
``psa_scan.psa_align`` on JAX's own cases (``tests/test_psa_ring.py``,
``tests/test_parallel.py``), against JAX's ``align_long_ring`` on the
virtual 8-device mesh in interpret mode and JAX's ``longseq.align_long``
on its (2, 4) mesh; the plain schedule's edge packets against full rows of
the port's ``psa_scan``; the mesh's shapes and errors against JAX's.
Zero tolerance: every score, corner and packet value equal.
"""

import jax
import numpy as np
import pytest
import torch

from tsta_tpu.config import AlignParams as JParams
from tsta_tpu.ops import psa_ring as jring
from tsta_tpu.ops import psa_scan as jscan
from tsta_tpu.parallel import longseq as jlongseq
from tsta_tpu.parallel import mesh as jmesh
from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import DeviceError
from tsta_tpu_torch.ops import psa_diff, psa_ring, psa_scan
from tsta_tpu_torch.parallel import batch, longseq
from tsta_tpu_torch.parallel import mesh as meshlib

CPU = torch.device("cpu")
EDIT = (0, -1, -1, 0)
JAX_CASES = [
    (1024, 96, 32, 8),      # one 128-column segment per shard, padded rows
    (2048, 128, 32, 8),     # two per shard
    (1000, 100, 32, 8),     # ragged real lengths inside the padding
    (1024, 64, 32, 2),      # 2-shard chain
    (512, 64, 32, 1),       # one shard: no packet at all
]


def _mesh(seq, data=1):
    return meshlib.make_mesh(data, seq, devices=[CPU] * (data * seq))


def _rand_pair(rng, n, m):
    return (rng.integers(65, 69, n).astype(np.uint8),
            rng.integers(65, 69, m).astype(np.uint8))


def _oracle(a, b, params):
    ref = jscan.psa_align(a, b, JParams(*params))
    return int(ref.score), int(ref.last)


@pytest.mark.parametrize("n,m,T,d", JAX_CASES)
def test_ring_matches_oracle(n, m, T, d):
    a, b = _rand_pair(np.random.default_rng(n + m + d), n, m)
    got = psa_ring.align_long_ring(a, b, AlignParams(), mesh=_mesh(d), T=T)
    assert got == _oracle(a, b, (2, -5, -2, -4))


@pytest.mark.parametrize("n,m,T,d", JAX_CASES)
def test_longseq_matches_oracle(n, m, T, d):
    a, b = _rand_pair(np.random.default_rng(n + m + d), n, m)
    got = longseq.align_long(a, b, AlignParams(), mesh=_mesh(d), block=T)
    assert got == _oracle(a, b, (2, -5, -2, -4))


@pytest.mark.parametrize("params", [(3, -2, -1, -6), EDIT])
@pytest.mark.parametrize("n,m,d", [(1024, 96, 4), (1000, 100, 8),
                                   (300, 500, 2)])
def test_other_params_match_oracle(params, n, m, d):
    """JAX's non-default set and edit scoring (M = 0: the corner is minus
    the edit distance), ring and longseq, columns wider and narrower than
    rows."""
    a, b = _rand_pair(np.random.default_rng(5 + n + d), n, m)
    want = _oracle(a, b, params)
    p = AlignParams(*params)
    assert psa_ring.align_long_ring(a, b, p, mesh=_mesh(d), T=32) == want
    assert longseq.align_long(a, b, p, mesh=_mesh(d)) == want


@pytest.mark.parametrize("n,m,T,d,params", [
    (1000, 100, 32, 8, (2, -5, -2, -4)),
    (1024, 96, 32, 4, (3, -2, -1, -6)),
])
def test_ring_matches_jax_ring(n, m, T, d, params):
    """JAX's own ring kernel on its virtual 8-device mesh, TPU interpret
    mode (about 11 s a case on a CPU)."""
    a, b = _rand_pair(np.random.default_rng(n + m + d), n, m)
    want = jring.align_long_ring(a, b, JParams(*params),
                                 mesh=jax.make_mesh((d,), ("seq",)), T=T)
    got = psa_ring.align_long_ring(a, b, AlignParams(*params), mesh=_mesh(d),
                                   T=T)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_longseq_matches_jax_longseq(seed):
    """JAX's ``test_longseq_sharded_matches_oracle`` cases on a (2, 4)
    mesh of both packages: the data axis only replicates."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(64, 1200)), int(rng.integers(20, 300))
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = rng.integers(65, 69, m).astype(np.uint8)
    params = (2, -5, -2, -4) if seed % 2 == 0 else (3, -2, -1, -6)
    want = jlongseq.align_long(a, b, JParams(*params),
                               mesh=jmesh.make_mesh(data=2, seq=4))
    got = longseq.align_long(a, b, AlignParams(*params),
                             mesh=_mesh(4, data=2))
    assert got == want == _oracle(a, b, params)


def _full_rows(a_p, b_p, params):
    """H and C of every row of the padded pair, from one-row
    ``psa_scan.scan_from`` passes: (m, n) int64 numpy each."""
    m_, x_, e_, o_ = params
    n, m = a_p.shape[0], b_p.shape[0]
    a = torch.from_numpy(a_p).view(1, n)
    j = np.arange(n, dtype=np.int64)
    h_prev = o_ + (j + 1) * e_
    h = e = None
    H, Cm = [], []
    for i in range(m):
        bi = torch.from_numpy(b_p[i:i + 1]).view(1, 1)
        _, _, _, h, e = psa_scan.scan_from(a, bi, torch.tensor([n]),
                                           torch.tensor([1]), params,
                                           row_base=i, h=h, e=e)
        bound_prev = 0 if i == 0 else o_ + i * e_
        diag = np.concatenate([[bound_prev], h_prev[:-1]]) + np.where(
            a_p == b_p[i], m_, x_)
        Cm.append(np.maximum(diag, e[0].numpy().astype(np.int64)))
        h_prev = h[0].numpy().astype(np.int64)
        H.append(h_prev)
    return np.stack(H), np.stack(Cm)


@pytest.mark.parametrize("n,m,T,d,params", [
    (1000, 100, 32, 8, (2, -5, -2, -4)),
    (1024, 64, 16, 4, EDIT),
])
def test_plain_packets_are_full_row_values(n, m, T, d, params):
    """Each packet lane is a value of the whole DP: shard d's edge H of
    row i is H(i, (d+1)C - 1), and its F prefix the running max of
    C(k) - k*e up to that column, seeded with H(i, -1) + e."""
    m_, x_, e_, o_ = params
    a, b = _rand_pair(np.random.default_rng(n * d), n, m)
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(a, b, d, T)
    out, comm = psa_ring.ring_plain(torch.from_numpy(a_p),
                                    torch.from_numpy(b_p), n_real, m_real,
                                    params, d, T)
    H, Cm = _full_rows(a_p, b_p, params)
    mp, n_pad = H.shape
    C = n_pad // d
    rows = np.arange(mp)
    j = np.arange(n_pad, dtype=np.int64)
    seed = o_ + (rows + 1) * e_ + e_
    prefix = np.maximum(seed[:, None],
                        np.maximum.accumulate(Cm - j * e_, axis=1))
    h_top = o_ + (j + 1) * e_
    H_prev = np.concatenate([h_top[None], H[:-1]])     # row i - 1
    comm = comm.numpy().reshape(d, mp // T, 2, T)
    edge = comm[:, :, 0, :].reshape(d, mp)   # lane r of block rb: row rb*T+r
    fpre = comm[:, :, 1, :].reshape(d, mp)
    last = (np.arange(d) + 1) * C - 1
    assert np.array_equal(edge, H_prev[:, last].T)
    assert np.array_equal(fpre, prefix[:, last].T)
    best, corner = out.amax(dim=0).tolist()
    assert best == int(H[:m_real].max())
    assert corner == int(H[m_real - 1, n_real - 1])
    assert (best, corner) == _oracle(a, b, params)


def test_mesh_shapes_and_errors():
    mesh = _mesh(4, data=2)
    assert mesh.shape == {"data": 2, "seq": 4}
    assert mesh.axis_names == ("data", "seq")
    assert mesh.devices.shape == (2, 4)
    assert all(d == CPU for d in mesh.devices.flat)
    assert meshlib.make_mesh(seq=2, devices=[CPU] * 8).shape == \
        jmesh.make_mesh(seq=2).shape
    jdevs = jax.devices()
    for data, seq in [(3, 3), (None, 9), (0, 1), (1, 0)]:
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(data, seq, devices=jdevs)
        with pytest.raises(ValueError) as got:
            meshlib.make_mesh(data, seq, devices=[CPU] * len(jdevs))
        assert str(got.value) == str(want.value)


def test_mesh_defaults_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        meshlib.make_mesh()


def test_value_errors():
    a = np.frombuffer(b"ACGT", np.uint8)
    for fn in (psa_ring.align_long_ring, longseq.align_long):
        with pytest.raises(ValueError):
            fn(a, a, AlignParams(), mesh=None)
        with pytest.raises(ValueError):
            fn(np.zeros(0, np.uint8), a, AlignParams(), mesh=_mesh(2))
        with pytest.raises(ValueError):
            fn(a, np.zeros(0, np.uint8), AlignParams(), mesh=_mesh(2))
    with pytest.raises(ValueError):
        jring.align_long_ring(np.zeros(0, np.uint8), a, JParams(),
                              mesh=jax.make_mesh((2,), ("seq",)))


def test_seq_axis_routes():
    """A CPU row runs the plain version, one card repeated one launch, a
    row of distinct cards one launch a card (the route function decides
    it without touching a card); a mix of types is an error, and a card
    mesh on a host without one raises DeviceError."""
    a = np.frombuffer(b"ACGTTGCA", np.uint8)
    assert meshlib.seq_route(_mesh(3)) == ("cpu", [CPU] * 3)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    two = meshlib.make_mesh(1, 2, devices=cards)
    assert meshlib.seq_route(two) == ("cards", cards)
    one = meshlib.make_mesh(2, 2, devices=[torch.device("cuda", 1)] * 4)
    assert meshlib.seq_route(one) == ("one_card", [torch.device("cuda", 1)]
                                      * 2)
    mixed = meshlib.make_mesh(1, 2, devices=[CPU, torch.device("cuda", 0)])
    with pytest.raises(ValueError):
        meshlib.seq_route(mixed)
    for fn in (psa_ring.align_long_ring, longseq.align_long):
        with pytest.raises(ValueError):
            fn(a, a, AlignParams(), mesh=mixed)
    if not torch.cuda.is_available():
        card = meshlib.make_mesh(1, 4, devices=["cuda:0"] * 4)
        for mesh in (card, two):
            with pytest.raises(DeviceError):
                psa_ring.align_long_ring(a, a, AlignParams(), mesh=mesh)


def test_ring_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the route is the plain version; the kernel's
    wrapper itself takes CUDA tensors only."""
    a_p, b_p, n_real, m_real = psa_ring.pad_pair(b"ACGT", b"ACG", 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        psa_ring.ring_kernel(torch.from_numpy(a_p), torch.from_numpy(b_p),
                             n_real, m_real, (2, -5, -2, -4), 2, 4)
    assert psa_ring.run_ring(torch.from_numpy(a_p), torch.from_numpy(b_p),
                             n_real, m_real, (2, -5, -2, -4), 2, 4) == \
        _oracle(a_p[:n_real], b_p[:m_real], (2, -5, -2, -4))


def test_data_axis_refusals_name_what_exists():
    """``mesh=`` on the batch and MSA entry points, once refused, now
    shares a batch over the ``data`` axis and an MSA round's columns over
    the ``seq`` axis: each gives the meshless call's values."""
    from tsta_tpu_torch.models import msa
    a = np.frombuffer(b"ACGTAC", np.uint8)
    mesh = _mesh(4, data=2)
    calls = [
        lambda **kw: psa_diff.psa_align_batch_diff([(a, a)], (2, -5, -2, -4),
                                                   **kw)[0].tolist(),
        lambda **kw: psa_diff.psa_align_batch_traced_packed(
            [(a, a)], (2, -5, -2, -4), **kw),
        lambda **kw: [(r.score, r.last) for r in batch.align_batch(
            [(a, a)], **kw)],
        lambda **kw: msa.align_seqs([b"ACGT", b"ACGA"], engine="native",
                                    **kw),
    ]
    for call in calls:
        assert call(mesh=mesh) == call(device="cpu")
