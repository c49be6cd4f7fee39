"""The narrow-dtype max probe (Q2-17d) on the CPU, with exact equality.

``tsta_tpu_torch.tools.dtype_max_probe.plain`` (numpy, the card kernel's
plain version) against the TPU probe's own kernel: the body of
``scripts/dtype_max_probe.py``'s ``make`` (its ``kern`` and
``pallas_call``) taken from the script's source, since the script runs
on import, and called through ``pallas_call(..., interpret=True)`` at a
small ITERS, for every dtype the script probes; and the DPX forms' plain
versions against their definitions lane by lane.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from tsta_tpu_torch.tools import dtype_max_probe as probe

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "dtype_max_probe.py")


def _tpu_make(iters):
    """The script's ``make``, compiled from its source with ITERS =
    ``iters`` and ``pallas_call`` in interpret mode."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    make = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "make")
    shim = type("pl", (), {"pallas_call": staticmethod(functools.partial(
        pl.pallas_call, interpret=True))})
    ns = {"jax": jax, "jnp": jnp, "pl": shim, "ROWS": probe.ROWS,
          "L": probe.LANES, "ITERS": iters}
    exec(compile(ast.Module([make], []), SCRIPT, "exec"), ns)
    return ns["make"]


@pytest.mark.parametrize("name", ["int32", "int16", "uint16", "int8",
                                  "uint8"])
def test_plain_equals_the_tpu_probe_kernel(name):
    iters = 3
    x, y = probe.tile(name)
    dt = jnp.dtype(probe.FORMS[name][0])
    got = np.asarray(_tpu_make(iters)(dt)(jnp.asarray(x), jnp.asarray(y)))
    want = probe.plain(name, x, y, iters)
    assert got.dtype == want.dtype == x.dtype
    assert np.array_equal(got, want)
    assert np.array_equal(want, np.maximum(x, y))


@pytest.mark.parametrize("name", ["viaddmax_s32", "viaddmax_s16x2",
                                  "vimax3_s32", "vimax3_s16x2"])
def test_dpx_forms_plain_against_their_definitions(name):
    """viaddmax: c = max(c + y, x) four times a round, from c = x; no
    lane leaves int16 over the smoke's 2,000 rounds (y <= 1 climbs at
    most 8,000 from x <= 1,000); vimax3: max(c, y, x), so max(x, y)."""
    x, y = probe.tile(name)
    iters = 5
    got = probe.plain(name, x, y, iters)
    c = x.astype(np.int64)
    for _ in range(4 * iters):
        c = (np.maximum(c + y, x) if probe.FORMS[name][2] == "viaddmax"
             else np.maximum(np.maximum(c, y), x))
    assert got.dtype == x.dtype and np.array_equal(got.astype(np.int64), c)
    if probe.FORMS[name][2] == "viaddmax":
        assert x.min() >= -1000 and x.max() <= 1000 and y.max() <= 1
        assert 1000 + 4 * 2000 < np.iinfo(np.int16).max


def test_probe_refuses_cpu_tensors():
    import torch
    x, y = (torch.from_numpy(t) for t in probe.tile("int16"))
    with pytest.raises(ValueError, match="CUDA"):
        probe.run("int16", x, y, 1, 1)
