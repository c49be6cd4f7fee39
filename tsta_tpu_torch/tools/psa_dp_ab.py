"""The PSA DP kernels in two checkouts on one card: K1's compiled code side
by side, then the chosen kernel's times, alternating, outputs compared.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    python -m tsta_tpu_torch.tools.psa_dp_ab --other DIR \
        [--kernel k1|ring|traced|chunk|short|striped|diff] [--rounds 2]

``DIR`` is the root of another checkout of the repo, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.

1. **Code.**  Each checkout's ``psa_dp.cu`` is compiled to a cubin with the
   port's flags and ``-Xptxas -v``.  For K1 (the score-only kernel, or its
   instantiation with every bool template argument false: the one with
   its frontier in shared memory, which 128 x 10,240 bp runs) it prints
   ptxas's resource lines and its SASS (``cuobjdump -sass``), the
   instructions compared with the constant-bank offsets of the kernel's
   parameters masked, since a new parameter moves them.  With ``--kernel
   short``, ``striped`` or ``diff`` it also prints ptxas's lines
   (registers, spills) for every entry of each checkout's
   ``psa_dp_short.cu``, ``psa_dp_striped.cu`` or ``psa_dp_diff.cu``.
2. **Time.**  Each run is a fresh process started in one checkout's root
   with that root on ``PYTHONPATH``: it builds that checkout's kernels and
   times, with CUDA events, the median of ``--reps`` after a warm-up:

   * ``k1``: ``psa_diff.dp_packed`` score-only (one K1 launch) on 128
     pairs of 10,240 bp made from ``--seed`` (the smoke's K1 shape), on
     the first of them alone and, one launch with no warm-up, on reads 0
     and 1 of the seed-13 200 kbp set cut to 100,000 bp (a parent's one
     block a pair takes seconds there);
   * ``ring``: ``psa_ring.ring_kernel`` on that set's 200 kbp pair (read
     1 against read 0, as the smoke's phase 19) at D = 132, T = 256;
   * ``traced``: ``psa_diff.dp_packed(traced=True)`` (K2) on the 10 kbp
     example (``tests/golden/example_big``), on 32 x 10 kbp (slot 0 the
     example, the rest from ``--seed``) and, one launch with no warm-up,
     on reads 0 and 1 of the seed-13 200 kbp set cut to 100,000 bp;
   * ``chunk``: ``psa_chunked.chunk_dp`` (Q2-7) on chunk 0 of reads 0 and
     1 of that set at 65,536 rows per chunk (65,536 x 200,064);
   * ``short``: the route (``psa_pallas.psa_align_batch``, host clock)
     on the smoke's phase 16 (c) batch, 4,096 pairs of 150-2,000 bp under
     edit scoring, its first call in the process and ``--reps`` later
     ones; then ``psa_pallas.dp_short`` (Q2-15) on them, warm and
     cold (the 50 MB L2 flushed by a 256 MB write before each run), and K1
     (``psa_diff.run_dp``) on the same pairs; where the checkout's
     ``_kernels.psa_dp_short`` takes ``per_sm``, also at 1, 2 and 3 blocks
     an SM;
   * ``striped``: ``psa_diff.run_dp_striped`` (Q2-11) on the 128 pairs of
     10,240 bp of ``k1`` as striped tiles, warm and cold, and K1 on the
     same pairs;
   * ``diff``: ``psa_diff.run_dp_int16`` (Q2-9) on those 128 pairs and on
     the int16 probe's 32 x 10,240 bp (slot 0 the 10 kbp example, as
     ``bench.stage_int16_probe``), warm and cold, and K1 on the same
     pairs.

   Each round runs other, this, this, other, so neither side always goes
   first.

Prints one JSON object per line; the last is the summary: for each shape
each side's median of its runs' medians, this over other, and whether
every run's outputs agree (scores and corners byte for byte, each plane
and frontier through a checksum computed on the card).
"""

from __future__ import annotations

import argparse
import difflib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

from tsta_tpu_torch.ops import _kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# what a timed process (of this tool or ``psa_walk_ab``) starts with, run
# in either checkout: only what both have.  The caller sets ``rng``.
CHILD_HELPERS = r"""
import hashlib, json, os, statistics, sys
import numpy as np, torch
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.ops import _kernels, psa_diff
dev = torch.device("cuda")
P = AlignParams()
p = (P.match, P.mismatch, P.gap_extend, P.gap_open)
acgt = np.frombuffer(b"ACGT", np.uint8)


def mutated(n, subs, dels):
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = a.copy()
    b[rng.integers(0, n, subs)] = rng.integers(0, 4, subs)
    return acgt[a], acgt[np.delete(b, rng.integers(0, n, dels))]


def long_reads(seed=13, length=200000):
    r = np.random.default_rng(seed)
    base = r.choice(acgt, length).tobytes()

    def mut(s, rate):
        s = np.frombuffer(s, np.uint8).copy()
        m = r.random(len(s)) < rate
        s[m] = acgt[r.integers(0, 4, m.sum())]
        return np.delete(s, r.integers(0, len(s), len(s) // 50)).tobytes()

    return [base, mut(base, 0.05), mut(base, 0.08)]


def example():
    with open(os.path.join("tests", "golden", "example_big",
                           "psa_default.out"), "rb") as f:
        lines = f.read().split(b"\n")
    return tuple(np.frombuffer(lines[k].replace(b"-", b""), np.uint8)
                 for k in (1, 3))


def checksum(t):
    # per 64 MB slice of int32 words, their sum and their sum weighted by
    # position, accumulated in int64 on the card
    v = t.reshape(-1).view(torch.uint8)
    out = []
    for k in range(0, v.numel(), 1 << 26):
        x = v[k:k + (1 << 26)]
        if x.numel() % 4:
            x = torch.cat([x, x.new_zeros(4 - x.numel() % 4)])
        w = x.view(torch.int32).to(torch.int64)
        out += [int(w.sum()), int((w * torch.arange(
            1, w.numel() + 1, device=w.device)).sum())]
    return hashlib.sha256(json.dumps(out).encode()).hexdigest()


def timed(fn, reps, warm=True, flush=None):
    # CUDA events, the median of reps after a warm-up; with ``flush``, a
    # write of that tensor before each run (L2 cold)
    out = fn() if warm else None
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return ms, out
"""

# the timed process of this tool
CHILD = CHILD_HELPERS + r"""
kernel, seed, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(seed)


def record(ms, outs, counter):
    return {"ms": ms, "median_ms": statistics.median(ms),
            "launches": _kernels.launches[counter],
            "outputs": hashlib.sha256(json.dumps(
                [checksum(o) for o in outs]).encode()).hexdigest()}


res = {}
if kernel == "k1":
    pairs = [mutated(10240, 1280, 170) for _ in range(128)]
    a, b, lens = psa_diff.pack_pairs(pairs, dev)
    ms, out = timed(lambda: psa_diff.dp_packed(a, b, lens, p), reps)
    res["128 x 10240 score-only"] = record(ms, out, "psa_dp_score")
    reads = long_reads()
    for label, group, n in (
            ("1 x 10240 score-only", pairs[:1], reps),
            ("1 x 100 kbp score-only", [tuple(np.frombuffer(
                r[:100000], np.uint8) for r in reads[:2])], 1)):
        a, b, lens = psa_diff.pack_pairs(group, dev)
        ms, out = timed(lambda: psa_diff.dp_packed(a, b, lens, p), n,
                        warm=n > 1)
        res[label] = record(ms, out, "psa_dp_score")
elif kernel == "ring":
    from tsta_tpu_torch.ops import psa_ring
    reads = long_reads()
    a, b, n_real, m_real = psa_ring.pad_pair(reads[1], reads[0], 132, 256)
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    ms, out = timed(lambda: psa_ring.ring_kernel(a, b, n_real, m_real, p,
                                                 132, 256), reps)
    res["200 kbp ring D = 132, T = 256"] = record(ms, out, "psa_ring")
elif kernel == "traced":
    ex = example()
    reads = long_reads()
    shapes = [("1 x 10 kbp", [ex], reps),
              ("32 x 10 kbp",
               [ex] + [mutated(10000, 1250, 200) for _ in range(31)], reps),
              ("1 x 100 kbp", [tuple(np.frombuffer(r[:100000], np.uint8)
                                     for r in reads[:2])], 1)]
    for label, group, n in shapes:
        a, b, nm = psa_diff.pack_pairs(group, dev, traced=True)
        ms, out = timed(lambda: psa_diff.dp_packed(a, b, nm, p, True), n,
                        warm=n > 1)
        res[label] = record(ms, out, "psa_dp_traced")
        res[label]["shape"] = [len(group), b.shape[1], a.shape[1]]
        del a, b, nm, out
        torch.cuda.empty_cache()
elif kernel == "short":
    import time

    import chip_smoke as cs
    from tsta_tpu_torch.ops import psa_pallas
    pairs = cs.short_pairs(np.random.default_rng(cs.SEED + 16), 4096)
    edit = cs.EDIT
    # the route end to end (host clock): its first call in this process,
    # then later ones
    walls = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        out = psa_pallas.psa_align_batch(pairs, edit, device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    out = [torch.from_numpy(x).to(dev) for x in out]
    res["route first call"] = record(walls[:1], out, "psa_dp_short")
    res["route later calls"] = record(walls[1:], out, "psa_dp_short")
    a, b, lens = psa_diff.pack_pairs(pairs, dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    runs = [("", lambda: psa_pallas.dp_short(a, b, lens, edit),
             "psa_dp_short"),
            ("K1 ", lambda: psa_diff.run_dp(a, b, lens, edit),
             "psa_dp_score")]
    if hasattr(_kernels, "psa_dp_short_layout"):
        def at(per_sm):
            def run():
                out = tuple(torch.empty(len(pairs), dtype=torch.int32,
                                        device=dev) for _ in range(2))
                _kernels.psa_dp_short(a, b, lens, edit, *out, per_sm=per_sm)
                return out
            return run
        runs += [("%d an SM " % k, at(k), "psa_dp_short") for k in (1, 2, 3)]
    for tag, fn, counter in runs:
        for cold in (False, True):
            label = "%s4096 short pairs %s" % (tag, "cold" if cold else "warm")
            ms, out = timed(fn, reps, flush=flush if cold else None)
            res[label] = record(ms, out, counter)
elif kernel in ("striped", "diff"):
    pairs = [mutated(10240, 1280, 170) for _ in range(128)]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    groups = [("128 x 10240", pairs)]
    if kernel == "diff":
        prng = np.random.default_rng(0)
        groups.append(("32 x 10240 int16 probe", [example()] + [
            tuple(prng.integers(65, 69, 10240).astype(np.uint8)
                  for _ in range(2)) for _ in range(31)]))
    for label, group in groups:
        a, b, lens = psa_diff.pack_pairs(group, dev)
        if kernel == "striped":
            tile, tb_, tl = psa_diff.pack_pairs_striped(group, dev)
            fn = lambda: psa_diff.run_dp_striped(tile, tb_, tl, p)
        else:
            fn = lambda: psa_diff.run_dp_int16(a, b, lens, p)
        runs = [(kernel, fn, "psa_dp_" + kernel),
                ("K1", lambda: psa_diff.run_dp(a, b, lens, p),
                 "psa_dp_score")]
        for tag, f, counter in runs:
            for cold in (False, True):
                ms, out = timed(f, reps, flush=flush if cold else None)
                res["%s %s %s" % (tag, label, "cold" if cold else "warm")] = \
                    record(ms, out, counter)
else:
    from tsta_tpu_torch.ops import psa_chunked
    reads = long_reads()
    pair = psa_chunked.ChunkedPair(
        *(np.frombuffer(r, np.uint8) for r in reads[:2]), p, 65536, dev)
    args = pair.chunk_call(0, *pair.entry())
    ms, out = timed(lambda: psa_chunked.chunk_dp(*args), reps)
    res["65536 x %d chunk 0" % pair.n_pad] = record(ms, out, "psa_dp_chunk")
print(json.dumps({"shapes": res, "build_s": _kernels.build_info.get(
    "seconds")}))
"""

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SASS_FUN = re.compile(r"Function : (\w+)")
_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_CBANK = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def is_k1(name: str) -> bool:
    """Whether a mangled ``psa_dp_kernel`` is K1's: the plain function
    (``psa_dp.cu``'s one block a pair), or an instantiation with every
    bool template argument false (the sharded body's shared-memory
    frontier ``<false>`` beside its global one; ``<false>`` beside the
    traced ``<true>``, or ``<256, false, false>`` in a checkout that still
    has the row-chunk mode)."""
    if re.search(r"13psa_dp_kernelEP", name):
        return True
    m = re.search(r"psa_dp_kernelI((?:L[a-z]-?\d+E)+)E", name)
    return bool(m) and "Lb1E" not in m.group(1)


def ptxas_entries(report: str) -> dict:
    """ptxas ``-v`` output, split by entry function: name -> its lines."""
    out, name = {}, None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(line.strip())
    return out


def sass_functions(dump: str) -> dict:
    """``cuobjdump -sass`` output: function name -> its instructions, with
    the parameters' constant-bank offsets masked."""
    out, name = {}, None
    for line in dump.splitlines():
        m = _SASS_FUN.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _SASS_INSN.search(line)
        if name is not None and m:
            out[name].append(_CBANK.sub("c[0x0][.]", m.group(1)))
    return out


def k1_code(root: str, work: str, tag: str) -> dict:
    """Compile ``root``'s ``psa_dp.cu`` and return K1's mangled name,
    ptxas lines and masked SASS."""
    nvcc = _kernels.nvcc_path()
    src = os.path.join(root, "tsta_tpu_torch", "csrc", "psa_dp.cu")
    cubin = os.path.join(work, tag + ".cubin")
    r = subprocess.run([nvcc] + _kernels.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", src,
                          "-o", cubin], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s" % (src, r.stderr))
    entries = ptxas_entries(r.stdout + r.stderr)
    names = [n for n in entries if is_k1(n)]
    if len(names) != 1:
        raise RuntimeError("K1 not found once in %s: %s" % (src, list(entries)))
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    return {"name": names[0], "ptxas": entries[names[0]],
            "sass": sass_functions(dump)[names[0]]}


_KERNEL_KEY = re.compile(r"([a-z_]+_kernel)I((?:L[a-z]+n?\d+E)+)E")


def kernel_key(name: str) -> str:
    """A mangled kernel's name and template arguments, without its
    namespace and parameter types (so ``poa_walk_kernel<Li0E>`` names one
    build whatever the spelling of its first parameter's type); a kernel
    that is no template by its name alone (an anonymous namespace's name
    carries a hash of the file's path)."""
    m = _KERNEL_KEY.search(name)
    if m:
        return m.group(1) + "<" + m.group(2) + ">"
    for run in re.finditer(r"\d+", name):   # <length><identifier>
        for k in range(run.start(), run.end()):
            ident = name[run.end():run.end() + int(name[k:run.end()])]
            if ident.endswith("_kernel") and ident[:1].isalpha():
                return ident
    return name


def source_code(root: str, work: str, tag: str, source: str) -> dict:
    """Compile ``root``'s ``csrc/<source>`` with the port's flags; per
    kernel (:func:`kernel_key`): its ptxas lines and masked SASS."""
    nvcc = _kernels.nvcc_path()
    src = os.path.join(root, "tsta_tpu_torch", "csrc", source)
    cubin = os.path.join(work, "%s.%s.cubin" % (tag, source))
    r = subprocess.run([nvcc] + _kernels.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", src,
                          "-o", cubin], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s" % (src, r.stderr))
    entries = ptxas_entries(r.stdout + r.stderr)
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    return {kernel_key(n): {"ptxas": entries.get(n, []), "sass": f}
            for n, f in sass_functions(dump).items()}


def compare_code(trees: dict, work: str, source: str) -> dict:
    """Each checkout's kernels of ``csrc/<source>`` side by side: per
    kernel the SASS instruction count of each side and, where both have
    it, whether the masked SASS is equal (and, where not, the first 40
    lines of the difference)."""
    code = {k: source_code(root, work, k, source) for k, root in trees.items()}
    out = {}
    for key in sorted(set(code["this"]) | set(code["other"])):
        have = {k: c[key] for k, c in code.items() if key in c}
        out[key] = {"instructions": {k: len(v["sass"])
                                     for k, v in have.items()},
                    "ptxas": {k: [x for x in v["ptxas"] if "Used" in x]
                              for k, v in have.items()}}
        if len(have) == 2:
            so, st = have["other"]["sass"], have["this"]["sass"]
            out[key]["sass_equal_masked"] = so == st
            if so != st:
                out[key]["sass_diff_lines"] = [
                    d for d in difflib.unified_diff(so, st, lineterm="", n=0)
                    if d[:1] in "+-" and d[:3] not in ("+++", "---")][:40]
    return out


def ptxas_report(root: str, work: str, tag: str, source: str) -> dict:
    """ptxas's lines (registers, spills, shared memory) for every entry of
    ``root``'s ``csrc/<source>``, compiled with the port's flags."""
    src = os.path.join(root, "tsta_tpu_torch", "csrc", source)
    r = subprocess.run([_kernels.nvcc_path()] + _kernels.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", src,
                          "-o", os.path.join(work, tag + ".report.cubin")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s" % (src, r.stderr))
    return ptxas_entries(r.stdout + r.stderr)


def child_run(root: str, child: str, argv: list) -> dict:
    """Run a timed process ``child`` in the checkout at ``root`` (its root
    the working directory and ``PYTHONPATH``) and return its last line."""
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", child] + [str(a) for a in argv],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=1800)
    if r.returncode:
        raise RuntimeError("timed run in %s failed:\n%s" % (root, r.stderr))
    return json.loads(r.stdout.strip().splitlines()[-1])


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def alternate(trees: dict, run, rounds: int) -> dict:
    """``rounds`` rounds of other, this, this, other, so neither side
    always goes first: ``run(root, first_this)`` times one checkout
    (``first_this``: the round's first run of this one) and returns its
    record, which is printed; returns each side's records' ``shapes``."""
    runs = {"other": [], "this": []}
    for rnd in range(rounds):
        for n, k in enumerate(("other", "this", "this", "other")):
            res = run(trees[k], n == 1)
            runs[k].append(res["shapes"])
            emit({"round": rnd, "tree": k, **res})
    return runs


def summarize(runs: dict) -> dict:
    """For each shape each side's median of its runs' medians, this over
    other, whether every run's outputs agree, and the runs themselves (and
    the shape's ``steps`` where its record has them)."""
    summary = {}
    for shape, first in runs["this"][0].items():
        # a shape only this checkout times (a new build) has no ratio
        have = {k: [r[shape] for r in v if shape in r]
                for k, v in runs.items()}
        have = {k: v for k, v in have.items() if v}
        med = {k: statistics.median(r["median_ms"] for r in v)
               for k, v in have.items()}
        summary[shape] = {
            "median_ms": med,
            "this_over_other": (med["this"] / med["other"] if "other" in med
                                else None),
            "outputs_equal": len({r["outputs"] for v in have.values()
                                  for r in v}) == 1,
            **({"steps": first["steps"]} if "steps" in first else {}),
            "runs": {k: [r["median_ms"] for r in v] for k, v in have.items()}}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--kernel", choices=("k1", "ring", "traced", "chunk",
                                         "short", "striped", "diff"),
                    default="k1", help="which DP to time (default k1)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}

    with tempfile.TemporaryDirectory() as work:
        code = {k: k1_code(root, work, k) for k, root in trees.items()}
        if args.kernel in ("short", "striped", "diff"):
            source = "psa_dp_%s.cu" % args.kernel
            emit({"ptxas " + source: {
                k: ptxas_report(root, work, k, source)
                for k, root in trees.items()}})
    so, st = code["other"]["sass"], code["this"]["sass"]
    diff = [d for d in difflib.unified_diff(so, st, lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("+++", "---")]
    emit({"code": {k: {"name": c["name"], "ptxas": c["ptxas"],
                       "instructions": len(c["sass"]),
                       "sass_sha256": hashlib.sha256(
                           "\n".join(c["sass"]).encode()).hexdigest()}
                   for k, c in code.items()},
          "sass_equal_masked": so == st, "sass_diff_lines": diff[:200],
          "sass_diff_count": len(diff)})

    runs = alternate(trees, lambda root, _: child_run(
        root, CHILD, [args.kernel, args.seed, args.reps]), args.rounds)
    emit({"kernel": args.kernel, "summary": summarize(runs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
