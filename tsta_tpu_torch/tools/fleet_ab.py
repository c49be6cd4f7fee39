"""The MSA fleet (``chip_smoke.py`` phase 10) in two checkouts on one card,
alternating.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.fleet_ab --other DIR [--calls 4]

``DIR`` is the root of another checkout, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory.  Each run is a
fresh process started in one checkout's root with that root on
``PYTHONPATH``: it builds that checkout's kernels, makes the fleet's six
5 x 5 kbp problems with that checkout's ``chip_smoke.fleet_problem``
(seeds 100-105) and times ``--calls`` calls of
``msa_native.align_seqs_many`` and of the six problems one by one (host
clock, synchronised).  The runs go other, this, this, other.  Prints one
JSON object per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the timed process, run in either checkout: only what both have
CHILD = r"""
import json, sys, time
import torch
import chip_smoke
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.ops import _kernels, msa_native
calls = int(sys.argv[1])
dev = torch.device("cuda", 0)
problems = [chip_smoke.fleet_problem(100 + i) for i in range(6)]
_kernels.build()
out = {"fleet_s": [], "one_by_one_s": []}
for _ in range(calls):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msa_native.align_seqs_many(problems, AlignParams(), device=dev)
    torch.cuda.synchronize()
    out["fleet_s"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for p in problems:
        msa_native.align_seqs(p, AlignParams(), device=dev)
    torch.cuda.synchronize()
    out["one_by_one_s"].append(time.perf_counter() - t0)
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    for k in ("other", "this", "this", "other"):
        r = subprocess.run([sys.executable, "-c", CHILD, str(args.calls)],
                           cwd=trees[k], capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=trees[k]),
                           timeout=600)
        if r.returncode:
            raise RuntimeError("run in %s failed:\n%s" % (trees[k], r.stderr))
        print(json.dumps({"tree": k,
                          **json.loads(r.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
