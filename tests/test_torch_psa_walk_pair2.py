"""The two-pair walk (Q2-12) on the CPU against the JAX package.

``traceback.walk_pair2_staged_plain`` emulates ``csrc/psa_walk_pair2.cu``
read by read (pairs 2q and 2q + 1 in one thread, each on its own window
ring after its guard; every read the kernel issues, the masked ones at a
walk's exit cell included, within that pair's window or its guard, and
every code a move depends on the right cell of that window); here it and
``walk_packed(pair2=True)`` (the plain walk on a CPU plane) are held to
JAX's
``_decode_moves_banded_packed(pair2=True)`` in interpret mode on the same
code planes, under the default and the edit scoring: pairs of very
unequal length (one drains in phase 0), m >> n and n >> m (long up and
left tails), P = 2 and P = 6.  Zero tolerance: every move, payload word
and count equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsta_tpu.ops import traceback as jtb
from tsta_tpu_torch import convert
from tsta_tpu_torch.ops import _kernels, psa_scan
from tsta_tpu_torch.ops import traceback as ttb

P0 = (2, -5, -2, -4)
EDIT = (0, -1, -1, 0)
# (n, m) of each pair
CASES = {
    "drain": [(1, 1), (700, 690)],
    "m_much_more": [(40, 900), (700, 650), (30, 700), (6, 260)],
    "n_much_more": [(900, 40), (700, 30)],
    "p2": [(500, 480), (300, 310)],
    "p6": [(512, 500), (400, 512), (130, 60), (9, 8), (1, 1), (700, 640)],
}
S_CASES = (8, 32, 64)


def _plane(lengths, params, seed=0):
    """Similar pairs of the given (n, m) (b ends in a copy of a, ~5%
    substituted and ~3% deleted, cut to its last m bases or led by random
    ones, so a pair with m >> n ends its walk in a long run up outside the
    matrix, n >> m in one left), their traced code
    plane from the port's plain DP, n_pad a multiple of 512 and m_pad of
    256 (the JAX walk's alignment); returns (plane, nm, Rp)."""
    rng = np.random.default_rng(seed)
    P = len(lengths)
    n_pad = -(-max(n for n, _ in lengths) // 512) * 512
    m_pad = -(-max(m for _, m in lengths) // 256) * 256
    a = np.full((P, n_pad), psa_scan.A_PAD, np.uint8)
    b = np.full((P, m_pad), psa_scan.B_PAD, np.uint8)
    for k, (n, m) in enumerate(lengths):
        a[k, :n] = rng.integers(65, 69, n)
        src = a[k, :n].copy()
        src[rng.integers(0, n, n // 20)] = rng.integers(65, 69, n // 20)
        src = np.delete(src, rng.integers(0, n, n // 30))
        b[k, :m] = np.concatenate([rng.integers(65, 69, m), src])[-m:]
    nm = torch.tensor(lengths, dtype=torch.int32)
    *_, plane = psa_scan.scan_rows(torch.from_numpy(a), torch.from_numpy(b),
                                   nm[:, 0], nm[:, 1], params, traced=True)
    return plane.contiguous(), nm, n_pad // 128


def _jax_pair2(monkeypatch, plane, nm, Rp):
    """JAX's two-pair walk on the port's plane: (words, counts), with its
    two-pair kernel traced."""
    traced = []
    orig = jtb._walk_kernel_packed_pair2

    def spy(*args, **kw):
        traced.append(True)
        return orig(*args, **kw)

    monkeypatch.setattr(jtb, "_walk_kernel_packed_pair2", spy)
    jtb._decode_moves_banded_packed.clear_cache()   # so that it traces anew
    words, counts = jtb._decode_moves_banded_packed(
        jnp.asarray(convert.plane_to_jax(plane)), jnp.asarray(nm.numpy()),
        Rp, True, pair2=True)
    assert traced
    return np.asarray(words), np.asarray(counts)


@pytest.mark.parametrize("params", [P0, EDIT], ids=["default", "edit"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pair2_walk_and_replay_match_jax(monkeypatch, case, params):
    """JAX's two-pair walk, the port's ``walk_packed(pair2=True)`` and the
    replay of the kernel's schedule at each S: the same counts, moves and
    payload words, no read outside either pair's window."""
    plane, nm, Rp = _plane(CASES[case], params)
    jw, jc = _jax_pair2(monkeypatch, plane, nm, Rp)
    gw, gc = ttb.walk_packed(plane, nm, pair2=True)
    assert gc.tolist() == jc.tolist()
    for k in range(len(nm)):
        c = int(gc[k])
        moves = ttb.unpack_moves(gw[k].numpy(), c)
        assert np.array_equal(moves, jtb.unpack_moves(jw[k], jc[k]))
        # the payload words (JAX leaves the words past its tail unwritten)
        nw = (c + 15) // 16
        assert np.array_equal(gw[k, :nw].numpy(), jw[k, :nw])
        assert not gw[k, nw:].any()
    for S in S_CASES:
        rw, rc = ttb.walk_pair2_staged_plain(plane, nm, S)
        assert torch.equal(rc, gc) and torch.equal(rw, gw)


def test_pair2_tails_and_drain_are_exercised():
    """The shapes above do what they are for: a pair done in phase 0 beside
    one of many phases; walks whose last moves are long runs up (m >> n)
    and left (n >> m)."""
    plane, nm, _ = _plane(CASES["drain"], P0)
    phases = []
    ttb.walk_pair2_staged_plain(plane, nm, 64, phases)
    w, c = ttb.walk_packed_plain(plane, nm)
    assert int(c[0]) == 1 and phases[0] >= 10
    for case, move in (("m_much_more", 2), ("n_much_more", 0)):
        plane, nm, _ = _plane(CASES[case], P0)
        w, c = ttb.walk_packed_plain(plane, nm)
        for k, (n, m) in enumerate(CASES[case]):
            if max(n, m) < 4 * min(n, m):
                continue
            moves = ttb.unpack_moves(w[k].numpy(), int(c[k]))
            run = len(moves) - len(np.trim_zeros(moves - move, "b"))
            assert run >= 50, (case, k, run)


def _code_plane(kind, shape, seed):
    if kind == "random":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 27, shape).astype(np.uint8))
    code = {"left": 3, "up": 19, "diagonal": 9}[kind]
    return torch.full(shape, code, dtype=torch.uint8)


@pytest.mark.parametrize("S", (8, 16, 32, 64))
@pytest.mark.parametrize("kind", ["left", "up", "diagonal", "random"])
def test_pair2_replay_on_synthetic_planes(kind, S):
    """Pure-left, pure-up, diagonal and random-code planes (forced runs),
    one narrower than any window, pairs of unequal length side by side:
    the replay equals the plain walk in every word and count, and each
    block's phases are its longer walk's."""
    for P, m_pad, n_pad in ((2, 300, 256), (4, 40, 1040), (2, 9, 16),
                            (6, 130, 144)):
        plane = _code_plane(kind, (P, m_pad, n_pad), 3 * P + S)
        nm = torch.tensor([[n_pad - p * (n_pad // (P + 1)),
                            max(1, m_pad - 7 * p)] for p in range(P)],
                          dtype=torch.int32)
        pw, pc = ttb.walk_packed_plain(plane, nm)
        phases = []
        rw, rc = ttb.walk_pair2_staged_plain(plane, nm, S, phases)
        assert torch.equal(rc, pc) and torch.equal(rw, pw)
        for q in range(P // 2):
            core = [_core_steps(pw[x].numpy(), int(pc[x]), *(
                int(v) for v in nm[x])) for x in (2 * q, 2 * q + 1)]
            assert phases[q] == max(1, -(-max(core) // S))


def _core_steps(words, count, n, m):
    """Steps of a walk taken inside the matrix (from (m - 1, n - 1) until
    i or j is -1): the kernel walks S of them a phase and its tail in the
    phase it leaves, so a block runs max(1, ceil(most / S)) phases."""
    i, j = m - 1, n - 1
    for k, move in enumerate(ttb.unpack_moves(words, count)):
        if i < 0 or j < 0:
            return k
        i -= move != 0
        j -= move != 2
    return count


@pytest.mark.parametrize("S", (8, 16, 64))
def test_pair2_replay_reads_before_a_window_land_in_its_guard(monkeypatch,
                                                              S):
    """A diagonal walk that leaves the matrix at column -1 one step before
    its phase ends issues its masked reads at that exit cell, the one
    above it a byte before the window: inside the pair's guard, and
    outside the window when the guard is taken away."""
    plane = _code_plane("diagonal", (2, 2 * S + 16, 2 * S + 16), 0)
    nm = torch.tensor([[2 * S - 1, 2 * S + 5]] * 2, dtype=torch.int32)
    reach = [0, 0]
    rw, rc = ttb.walk_pair2_staged_plain(plane, nm, S, reach=reach)
    pw, pc = ttb.walk_packed_plain(plane, nm)
    assert torch.equal(rc, pc) and torch.equal(rw, pw)
    assert reach[0] == -1 and reach[1] < (2 * S + 1) * (2 * S + 16)
    assert _kernels.pair2_guard(S) >= 1
    monkeypatch.setattr(_kernels, "pair2_guard", lambda S: 0)
    with pytest.raises(AssertionError, match="outside the window"):
        ttb.walk_pair2_staged_plain(plane, nm, S)


def test_pair2_replay_catches_a_read_outside_its_window(monkeypatch):
    """A window one row short (its anchor row left out) makes the replay
    raise: the check is not vacuous."""
    plane = _code_plane("diagonal", (2, 100, 128), 0)
    nm = torch.tensor([[100, 90], [60, 100]], dtype=torch.int32)
    real = ttb.walk_window

    def short(i0, j0, S, row_lo, rows, n_pad):
        r0, r1, c0, c1 = real(i0, j0, S, row_lo, rows, n_pad)
        return r0, max(r0, r1 - 1), c0, c1

    monkeypatch.setattr(ttb, "walk_window", short)
    with pytest.raises(AssertionError, match="outside the window"):
        ttb.walk_pair2_staged_plain(plane, nm, 16)


def test_pair2_replay_and_bytes_refuse_bad_shapes():
    """An odd P is not the two-pair walk's; its shared memory (a guard and
    a ring a pair) sets the longest phase it takes."""
    plane = _code_plane("left", (3, 8, 16), 0)
    nm = torch.tensor([[16, 8]] * 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ttb.walk_pair2_staged_plain(plane, nm, 8)
    assert _kernels.pair2_bytes(64) == 74_624
    assert _kernels.pair2_bytes(32) == 20_992
    assert _kernels.pair2_bytes(64) == 2 * (160 + _kernels.walk_ring_bytes(64))
    assert _kernels.walk_s(112, _kernels.pair2_bytes) == 112
    for S in (120, 128, 12):
        with pytest.raises(ValueError):
            _kernels.walk_s(S, _kernels.pair2_bytes)
    assert _kernels.walk_s(128) == 128   # one ring of 128 still fits
    assert _kernels.pair2_s(112) == 112 and _kernels.pair2_s() == 64
    with pytest.raises(ValueError):   # a CPU plane takes the plain walk
        ttb.walk_packed(plane[:2].contiguous(), nm[:2].contiguous(),
                        pair2=True, S=32)


def test_pair2_phase_length_stops_at_112_whatever_fits(monkeypatch):
    """The step keeps a cell offset's step (2S + 17) in a byte, so the
    phase length stops at 112 even where a block's shared memory would
    hold more."""
    monkeypatch.setattr(_kernels, "MAX_DYNAMIC_SMEM", 1 << 20)
    assert _kernels.walk_s(120, _kernels.pair2_bytes) == 120
    for S in (120, 128):
        with pytest.raises(ValueError, match="at most 112"):
            _kernels.pair2_s(S)
    assert _kernels.pair2_s(112) == 112


# ---- the walks' step loops in SASS, on hand-made listings ---------------

def _listing(name, prog):
    """A ``cuobjdump -sass`` function: each entry an instruction's text,
    or (text with one %s, the index of the instruction it branches to)."""
    lines = ["\t\tFunction : " + name]
    for k, ins in enumerate(prog):
        text = ins if isinstance(ins, str) else ins[0] % hex(16 * ins[1])
        lines.append("        /*%04x*/                   %s ;"
                     "                 /* 0x000fe40000000800 */"
                     % (16 * k, text))
    return "\n".join(lines) + "\n"


STEP = ["LDS.U8 R1, [R2]", "LDS.U8 R3, [R2+-0x1]", "LDS.U8 R4, [R2+-0x90]"]
# the phase loop (its barrier) around a step loop whose flush store is
# branched round: 3 loads and 4 more instructions on the step's cycle
ONE_PAIR = ["S2R R0, SR_TID.X", "BAR.SYNC.DEFER_BLOCKING 0x0",
            "MOV R2, R12"] + STEP + [
    "IADD3 R5, R5, 0x1, RZ", ("@!P3 BRA %s", 9), "STG.E [R10.64], R9",
    ("@P4 BRA %s", 3), "BAR.SYNC.DEFER_BLOCKING 0x0", ("@P5 BRA %s", 2),
    "EXIT"]
# two pairs a step, two steps a body: 12 loads, 6 more instructions
TWO_PAIRS = ["S2R R0, SR_TID.X", "BAR.SYNC.DEFER_BLOCKING 0x0",
             "MOV R2, R12"] + STEP + STEP + ["IADD3 R5, R5, 0x1, RZ",
                                             "IADD3 R6, R6, 0x1, RZ"] \
    + STEP + STEP + ["SEL R7, R7, R8, P1", ("@!P3 BRA %s", 20),
                     "STG.E [R10.64], R9", "LOP3.LUT P0, RZ, R5, R6, RZ",
                     "ISETP.GE.AND P4, PT, R5, RZ, PT", ("@P4 BRA %s", 3),
                     "BAR.SYNC.DEFER_BLOCKING 0x0", ("@P5 BRA %s", 2), "EXIT"]


def test_step_loops_count_instructions_a_step():
    """The step loop, not the phase loop that holds it; the flush store
    off its shortest cycle; a two-pair body's instructions over its
    pair-steps."""
    from tsta_tpu_torch.tools import walk_probes as wp
    (insns,) = wp.parse_sass(_listing("_Z1kv", ONE_PAIR)).values()
    assert wp.step_loops(insns) == [{"instructions": 7, "cycle": 6,
                                     "lds": 3, "per_step": 6.0}]
    (insns,) = wp.parse_sass(_listing("_Z1kv", TWO_PAIRS)).values()
    (loop,) = wp.step_loops(insns)
    assert (loop["lds"], loop["cycle"]) == (12, 19)
    assert loop["per_step"] == 19 / 4


def test_walk_sass_steps_names_the_three_walks():
    from tsta_tpu_torch.tools import walk_probes as wp
    text = (_listing("_ZN12_GLOBAL__N_115psa_walk_kernelEPKhPKiiiiPiiS4_i",
                     ONE_PAIR)
            + _listing("_ZN12_GLOBAL__N_123psa_walk_bounded_kernelEPKh",
                       ONE_PAIR)
            + _listing("_ZN12_GLOBAL__N_121psa_walk_pair2_kernelEPKhPKi",
                       TWO_PAIRS)
            + _listing("_ZN12_GLOBAL__N_115poa_walk_kernelEv", ONE_PAIR)
            + _listing("_ZN12_GLOBAL__N_112walk_probe_cILi0EEEvPKi",
                       ["S2R R0, SR_TID.X", "EXIT"]))
    got = wp.walk_sass_steps(text)
    assert sorted(got) == ["psa_walk", "psa_walk_bounded", "psa_walk_pair2"]
    assert got["psa_walk"]["per_step"] == 6.0
    assert got["psa_walk_pair2"]["per_step"] == 19 / 4


def test_kernel_key_names_a_kernel_of_an_anonymous_namespace():
    """The walk A/B pairs each checkout's walk kernels by name: an
    anonymous namespace's name carries a hash of the file's path, so two
    checkouts spell one kernel differently."""
    from tsta_tpu_torch.tools.psa_dp_ab import kernel_key
    for tag, name in (("15", "psa_walk_kernel"),
                      ("21", "psa_walk_pair2_kernel"),
                      ("23", "psa_walk_bounded_kernel")):
        keys = {kernel_key("_ZN44_GLOBAL__N__%s_11_psa_walk_cu_a80543c6%s%s"
                           "EPKhPKiiiiPiiS4_i" % (h, tag, name))
                for h in ("a1dffd99", "d067d060")}
        assert keys == {name}
    assert kernel_key("_ZN12_GLOBAL__N_115poa_walk_kernelILi0EEEvPKt") == \
        "poa_walk_kernel<Li0E>"
