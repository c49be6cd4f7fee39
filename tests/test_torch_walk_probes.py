"""The walk probes (Q2-17a, b, c, e) on the CPU, with exact equality.

``tsta_tpu_torch.tools.walk_probes.plain`` (the card kernels' plain
versions, one program replayed in Python integers) against the TPU probes'
own kernels: ``kernel`` and ``run_mode`` of ``scripts/walk_ablate.py``,
``walk_ablate2.py`` and ``walk_ablate3.py``, and ``kern`` and its call in
``scripts/db_probe.py``, taken from the scripts' source with their module
constants set to small sizes and ``pallas_call`` in interpret mode, every
mode's whole ``out`` compared, the words no mode writes (INT32_MIN in
interpret mode) included; the copies each mode makes; the tool's refusal
of CPU tensors; and the tool's reading of the walker loop from SASS, on
hand-made listings.
"""

import ast
import functools
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tsta_tpu_torch.ops import _kernels
from tsta_tpu_torch.tools import walk_probes as wp

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts")
FILES = {"a": "walk_ablate.py", "b": "walk_ablate2.py",
         "c": "walk_ablate3.py", "e": "db_probe.py"}
# the tests' sizes; BAND_R and BAND_W, and all of (e), as in the scripts
SMALL = {"a": dict(N=64), "b": dict(N=96),
         "c": dict(N=300, P=2, M_ROWS=512, N_W=1024), "e": {}}
CASES = [(p, m) for p in "abce" for m in _kernels.WALK_PROBE_MODES[p]]


def _script(probe, keep, consts):
    """The top-level statements of the probe's script for which ``keep``
    holds, run with ``consts`` as module globals and ``pallas_call`` in
    interpret mode; returns their namespace."""
    path = os.path.join(SCRIPTS, FILES[probe])
    with open(path) as f:
        tree = ast.parse(f.read())
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": shim, "pltpu": pltpu,
          "functools": functools, **consts}
    exec(compile(ast.Module([n for n in tree.body if keep(n)], []), path,
                 "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _tpu_out(probe, mode):
    """The TPU probe's whole ``out`` in interpret mode at SMALL's sizes."""
    if probe == "e":
        ns = _script("e", lambda n: (
            isinstance(n, ast.FunctionDef) and n.name == "kern") or (
            isinstance(n, ast.Assign) and ast.unparse(n.targets[0]).strip(
                "()") in ("R, WS, L", "x", "out")), {})
        return np.asarray(ns["out"])
    sz = {**wp.SIZES[probe], **SMALL[probe]}
    ns = _script(probe, lambda n: isinstance(n, ast.FunctionDef)
                 and n.name in ("kernel", "run_mode"), sz)
    _, host = wp.make_plane(probe, None, **sz)
    return np.asarray(ns["run_mode"](jnp.asarray(host), mode))


@pytest.mark.parametrize("probe,mode", CASES)
def test_plain_equals_the_tpu_probe_kernel(probe, mode):
    sz = SMALL[probe]
    _, host = wp.make_plane(probe, None, **sz)
    want, _ = wp.plain(probe, mode, host, **sz)
    got = _tpu_out(probe, mode)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("probe,mode", CASES)
def test_refetch_counts(probe, mode):
    """(a) and (b): none (bi0 starts at -2^30 and i >= 0); (c): every
    step t with t % period == 0 from t = 0, ceil(N / period), only in the
    DMA modes; (e): its two copies."""
    sz = SMALL[probe]
    _, host = wp.make_plane(probe, None, **sz)
    _, fetches = wp.plain(probe, mode, host, **sz)
    period = {"dma119": 119, "dma18": 18}.get(mode)
    want = 2 if probe == "e" else math.ceil(sz["N"] / period) if (
        probe == "c" and period) else 0
    assert fetches == want


@pytest.mark.parametrize("mode,count", [("dma119", 87), ("dma18", 569)])
def test_refetch_counts_at_the_scripts_steps(mode, count):
    """At N = 10,240 (a smaller plane: the count does not read it)."""
    sz = dict(M_ROWS=512, N_W=1024, P=1)
    _, host = wp.make_plane("c", None, **sz)
    out, fetches = wp.plain("c", mode, host, **sz)
    assert fetches == count == math.ceil(wp.SIZES["c"]["N"] / int(mode[3:]))
    assert out[0, 0] == wp.SIZES["c"]["N"]   # t + bi0, bi0 clipped to 0


def _constants(probe):
    with open(os.path.join(SCRIPTS, FILES[probe])) as f:
        tree = ast.parse(f.read())
    consts = {}
    for n in tree.body:
        if not isinstance(n, ast.Assign):
            continue
        try:
            value = ast.literal_eval(n.value)
        except ValueError:
            continue
        names = [t.id for t in ast.walk(n.targets[0])
                 if isinstance(t, ast.Name)]
        consts.update(zip(names, value if isinstance(value, tuple)
                          else (value,)))
    return consts


@pytest.mark.parametrize("probe", "abce")
def test_sizes_default_to_the_scripts(probe):
    consts = _constants(probe)
    want = {k: v for k, v in wp.SIZES[probe].items() if k != "STEPS"}
    assert {k: consts[k] for k in want} == want
    if probe in "ab":
        assert (want["BAND_R"], want["BAND_W"]) == _kernels.PROBE_AB_BAND
    if probe == "c":
        assert (want["BAND_R"], want["BAND_W"]) == _kernels.PROBE_C_BAND
    if probe == "e":
        assert (2 * want["R"], want["WS"], want["L"]) == _kernels.PROBE_E_X


def test_b_takes_a_multiple_of_eight_steps():
    _, host = wp.make_plane("b", None)
    with pytest.raises(ValueError, match="multiple of 8"):
        wp.plain("b", "full_unroll8", host, N=100)


@pytest.mark.parametrize("probe", "abce")
def test_tool_refuses_cpu_tensors(probe):
    sz = {**wp.SIZES[probe], **SMALL[probe]}
    n = sz.get("N", sz.get("STEPS"))
    plane, _ = wp.make_plane(probe, torch.device("cpu"), **sz)
    cols = _kernels.walk_probe_out_cols(probe, n)
    out = torch.full((sz.get("P", 1), cols), wp.INT32_MIN,
                     dtype=torch.int32)
    before = dict(_kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        wp.run(probe, _kernels.WALK_PROBE_MODES[probe][-1], plane, out, n)
    assert dict(_kernels.launches) == before


# ---- the walker loop in SASS, on hand-made listings ----------------------

def _listing(name, prog):
    """A ``cuobjdump -sass`` function: each entry an instruction's text,
    or (text with one %s, the index of the instruction it branches to)."""
    lines = ["\t\tFunction : " + name,
             '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"']
    for k, ins in enumerate(prog):
        text = ins if isinstance(ins, str) else ins[0] % hex(16 * ins[1])
        lines.append("        /*%04x*/                   %s ;"
                     "                 /* 0x000fe40000000800 */"
                     % (16 * k, text))
        lines.append("                                                   "
                     "     /* 0x000fc40003f06270 */")
    return "\n".join(lines) + "\n"


FILL = ["S2R R0, SR_TID.X", ("@P0 BRA %s", 4), "STS [R0], RZ",
        ("@!P1 BRA %s", 2), "BAR.SYNC.DEFER_BLOCKING 0x0", "@P2 EXIT"]
# the refetch inline: the step skips it (6 instructions a step, 11 in all);
# its wait's watchdog traps out of line (BPT.TRAP then a branch to itself,
# as ptxas lays out __trap())
INLINE = FILL + [
    "MOV R2, 0x27ff",
    "ISETP.GE.AND P3, PT, R2, R4, PT", ("@!P3 BRA %s", 14),
    "SYNCS.ARRIVE.TRANS64 RZ, [R5], R6", "UBLKCP.S.G [UR4], [UR6], UR8",
    ("@!P6 BRA %s", 20), "SYNCS.PHASECHK.TRANS64.TRYWAIT P4, [R5], R7",
    ("@!P4 BRA %s", 11), "LDS R7, [R8]", "IADD3 R2, R2, -0x1, RZ",
    "ISETP.GE.AND P5, PT, R2, RZ, PT", ("@P5 BRA %s", 7),
    "STG.E [R10.64], R9", "EXIT", "BPT.TRAP 0x1", ("BRA %s", 21), "NOP"]
# the refetch out of line, after the loop, jumping back into it
OUT_OF_LINE = FILL + [
    "ISETP.GE.AND P3, PT, R2, R4, PT", ("@P3 BRA %s", 13), "LDS R7, [R8]",
    "IADD3 R2, R2, -0x1, RZ", "ISETP.GE.AND P5, PT, R2, RZ, PT",
    ("@P5 BRA %s", 6), "EXIT", "UBLKCP.S.G [UR4], [UR6], UR8",
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P4, [R5], R7", ("@!P4 BRA %s", 14),
    ("BRA %s", 8), ("BRA %s", 17), "NOP"]
# (e): the copies' loop, then the reads' loop
TWO_LOOPS = FILL + [
    "UBLKCP.S.G [UR4], [UR6], UR8",
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R5], R7", ("@!P1 BRA %s", 7),
    "IADD3 R3, R3, 0x1, RZ", ("@P2 BRA %s", 6), "LDS R7, [R8]",
    "IADD3 R9, R9, R7, RZ", ("@P3 BRA %s", 11), "STG.E [R10.64], R9",
    "EXIT"]


@pytest.mark.parametrize("prog,want", [
    (INLINE, {"instructions": 11, "cycle": 6}),
    (OUT_OF_LINE, {"instructions": 10, "cycle": 6}),
    (TWO_LOOPS, {"instructions": 3, "cycle": 3}),
    (FILL + ["MOV R2, 0x1", "STG.E [R10.64], R2", "EXIT"], None)])
def test_walker_loop_is_the_last_outer_loop_after_the_barrier(prog, want):
    (insns,) = wp.parse_sass(_listing("_Z1kv", prog)).values()
    assert wp.walker_loop(insns) == want


def test_sass_steps_reads_each_kernel_and_its_steps_a_body():
    """Kernels found by name (a mode by its template argument, (e) by
    none), (b)'s unroll8 at 8 steps a body."""
    body = ["LDS R7, [R8]", "IADD3 R2, R2, -0x8, RZ", "STG.E [R4.64], R7",
            "ISETP.GE.AND P5, PT, R2, RZ, PT", ("@P5 BRA %s", 6), "EXIT"]
    b = _listing("_ZN12_GLOBAL__N_112walk_probe_bILi3EEEvPKiPiiiii",
                 FILL + body)
    e = _listing("_ZN12_GLOBAL__N_112walk_probe_eEPKiPii", FILL + body)
    other = _listing("_Z6psa_dpPKi", FILL + body)
    got = wp.sass_steps(b + e + other)
    assert got == {("b", "unroll8"): {"instructions": 5, "cycle": 5,
                                      "per_step": 5 / 8},
                   ("e", "db"): {"instructions": 5, "cycle": 5,
                                 "per_step": 5}}


def test_bound_takes_the_longer_rule():
    # (c): one dependent load a step, 30 cycles, against 10 instructions
    b = wp.bound("c", 10240, 10, 87, 8, 8 * 10248)
    chain = 10240 * 30 / wp.SM_CLOCK_HZ + 87 * 131072 / wp.HBM_BYTES_PER_S
    assert b["bound_rule"] == "chain" and b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(chain * 1e3)
    # (a): no load on the chain; 40 instructions a step at one a clock
    b = wp.bound("a", 10240, 40, 0, 8, 8 * 10241)
    assert b["bound_rule"] == "issue" and b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(10240 * 40 / wp.SM_CLOCK_HZ * 1e3)
    # (e): two 32 KB copies and 64 reads of 0.01 instructions: bytes
    b = wp.bound("e", 64, 0.01, 2, 1, 1)
    assert b["bound_rule"] == "bytes" and b["bound_by"] == "bytes"


def test_problems_name_each_failure():
    rec = {"equal": True, "sass_instr_per_step": 4.0, "scaling": 1.9,
           "ms": 1.0, "bound_ms": 0.5}
    assert wp.problems(rec) == []
    bad = dict(rec, equal=False, sass_instr_per_step=None, scaling=1.05,
               ms=0.4)
    assert len(wp.problems(bad)) == 4
