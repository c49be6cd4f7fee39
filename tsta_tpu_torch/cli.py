"""Command-line interface of the port (``tsta-torch``).

    tsta-torch psa  -1 a.fa -2 b.fa [-o out.txt] [--notrace] [flags]
    tsta-torch msa  -i reads.fa [-o out.txt] [--engine native] [flags]
    tsta-torch msa-batch --inputs fastas.txt --out-dir msas/ [flags]
    tsta-torch batch --pairs manifest.tsv [flags]

Same flags, stdout and output files as ``tsta psa`` / ``msa`` /
``msa-batch`` / ``batch`` of the JAX package, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions).  ``--kernel``
takes auto|plain|cuda, and the JAX CLI's scan (= plain) and pallas (=
cuda).  ``--profile DIR`` writes a ``torch.profiler`` Chrome/Perfetto
trace of the command into DIR.  ``psa`` and ``batch --traced`` run a pair
whose traceback plane exceeds the card's budget in row-chunks, with no
option.
``TSTA_DIFF_INT16`` set to any non-empty value sends ``psa --notrace`` and
``batch`` (M > 0) to the int16 difference method, as in the JAX package;
``TSTA_PSA_LAYOUT=striped`` sends them to the striped layout's DP.
``--mesh DATAxSEQ`` is a mesh of the visible cards (on ``--device cpu``
the CPU repeated DATA * SEQ times): ``batch`` shares its pairs over the
``data`` axis, ``msa --engine native`` runs each round's columns over
the ``seq`` axis.  ``msa --engine native`` run as several processes with
``TSTA_COORDINATOR``, ``TSTA_NUM_PROCESSES`` and ``TSTA_PROCESS_ID`` set
runs one MSA across them (``parallel/msa_multihost.py``, one window a
process); rank 0 writes the output.
"""

from __future__ import annotations

import argparse
import sys
import time

from tsta_tpu_torch.device import DEFAULT_DEVICE, DeviceError
from tsta_tpu_torch.utils.logging import emit_json, get_logger

_INT_FLAGS = {"-M", "-X", "-E", "-O", "-T", "-W"}
# the JAX CLI's --kernel values, as the port's routes that keep the values
KERNEL_ALIASES = {"scan": "plain", "pallas": "cuda"}


def _merge_negative_values(argv):
    """Rewrite ['-X', '-3'] to ['-X=-3'].

    argparse disables negative-number value detection when the parser has
    digit-named flags (the reference-compatible ``-1``/``-2``), so scoring
    flags with negative values would otherwise be rejected.
    """
    out = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if (tok in _INT_FLAGS and i + 1 < len(argv)
                and _is_int(argv[i + 1])):
            out.append(tok + "=" + argv[i + 1])
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _add_scoring_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-M", type=int, default=2, help="match score [2]")
    p.add_argument("-X", type=int, default=-5, help="mismatch score [-5]")
    p.add_argument("-E", type=int, default=-2, help="gap-extend score [-2]")
    p.add_argument("-O", type=int, default=-4, help="gap-open score [-4]")
    p.add_argument("-T", type=int, default=0,
                   help="threads for the compat MSA engine; ignored by "
                        "the PSA kernels")
    p.add_argument("-W", type=int, default=0,
                   help="block width multiplier of the compat MSA engine; "
                        "ignored by the PSA kernels, whose exact "
                        "arithmetic is block-size independent")
    p.add_argument("--json", action="store_true",
                   help="emit a JSON result line instead of reference stdout")
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "plain", "cuda", *KERNEL_ALIASES],
                   help="auto: the CUDA kernels where they apply; plain "
                        "(or scan): their plain PyTorch versions; cuda (or "
                        "pallas): kernels only")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the command into "
                        "DIR (Chrome/Perfetto)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device [%s]; 'cpu' runs the plain "
                        "versions" % DEFAULT_DEVICE)


def _params(args):
    from tsta_tpu_torch.config import AlignParams
    return AlignParams(match=args.M, mismatch=args.X, gap_extend=args.E,
                       gap_open=args.O)


def _launches() -> dict:
    from tsta_tpu_torch.ops import _kernels
    return dict(_kernels.launches)


def cmd_psa(args) -> int:
    from tsta_tpu_torch.models import psa
    t0 = time.time()
    out = psa.align_files(args.seq1, args.seq2, _params(args),
                          traced=not args.notrace, kernel=args.kernel,
                          device=args.device)
    wall = time.time() - t0
    if not args.notrace:
        psa.write_alignment(out, args.output)
    if args.json:
        emit_json({"score": out.score, "corner": out.corner,
                   "wall_s": round(wall, 4),
                   "output": None if args.notrace else args.output,
                   "device": args.device, "launches": _launches()})
    else:
        print("maxsorce=%d" % max(out.score, psa.REFERENCE_SCORE_FLOOR))
    return 0


def _mesh(args):
    """The mesh of ``--mesh`` on ``--device`` (None without one)."""
    if not args.mesh:
        return None
    from tsta_tpu_torch.parallel import mesh as meshlib
    return meshlib.cli_mesh(args.mesh, args.device)


def cmd_msa(args) -> int:
    from tsta_tpu_torch.models import msa
    from tsta_tpu_torch.ops import msa_native
    from tsta_tpu_torch.parallel import mesh as meshlib
    if args.mesh and args.engine != "native":
        raise ValueError("--mesh requires --engine native")
    mesh = _mesh(args)
    if args.engine == "native" and meshlib.maybe_init_distributed():
        return _msa_multihost(args, mesh)
    t0 = time.time()
    # -W maps to the compat engine's stripe multiplier; 0 means 10
    width = args.W if args.W > 0 else 10
    progress = None
    if args.engine == "native" and sys.stderr.isatty():
        # the reference's round progress bar (msa/msa.c:134-138)
        def progress(done, total):
            sys.stderr.write("\r[%d/%d]" % (done, total))
            sys.stderr.flush()
            if done == total:
                sys.stderr.write("\n")
    plain0 = msa_native.plain_rounds
    result = msa.align_file(args.input, _params(args), engine=args.engine,
                            width=width, mesh=mesh, threads=args.T,
                            progress=progress, kernel=args.kernel,
                            device=args.device)
    wall = time.time() - t0
    msa.write_result(result, args.output)
    if args.json:
        emit_json({"rounds": result.round_scores,
                   "graph_len": result.graph_len,
                   "add_len": result.add_len,
                   "consensus_len": len(result.consensus),
                   "wall_s": round(wall, 4), "output": args.output,
                   "engine": args.engine, "device": args.device,
                   "launches": _launches(),
                   "plain_rounds": msa_native.plain_rounds - plain0})
    return 0


def _msa_multihost(args, mesh) -> int:
    """``msa --engine native`` as one rank of a process group: every rank
    aligns, rank 0 writes the output (and the JSON line)."""
    from tsta_tpu_torch.io import read_records
    from tsta_tpu_torch.models import msa
    from tsta_tpu_torch.ops import msa_native
    from tsta_tpu_torch.parallel import msa_multihost
    seqs = [r.sequence for r in read_records(args.input)]
    for i, s in enumerate(seqs):
        if len(s) == 0:
            raise ValueError("sequence %d is empty" % i)
    plain0 = msa_native.plain_rounds
    t0 = time.time()
    result = msa_multihost.align_seqs_multihost(
        seqs, _params(args), mesh=mesh, device=args.device,
        kernel=args.kernel)
    wall = time.time() - t0
    rank, size = msa_multihost.world()
    if rank == 0:
        msa.write_result(result, args.output)
        if args.json:
            emit_json({"rounds": result.round_scores,
                       "graph_len": result.graph_len,
                       "add_len": result.add_len,
                       "consensus_len": len(result.consensus),
                       "wall_s": round(wall, 4), "output": args.output,
                       "engine": args.engine, "device": args.device,
                       "processes": size, "launches": _launches(),
                       "plain_rounds": msa_native.plain_rounds - plain0})
    return 0


def cmd_msa_batch(args) -> int:
    """Many independent MSAs through ``msa_native.align_seqs_many`` (one
    CUDA stream per problem, host merges overlapping device rounds)."""
    import os

    from tsta_tpu_torch.io import read_records
    from tsta_tpu_torch.models import msa
    from tsta_tpu_torch.ops import msa_native
    from tsta_tpu_torch.parallel.batch import stride_for_process

    with open(args.inputs) as f:
        stripped = (ln.strip() for ln in f)
        paths = [s for s in stripped if s and not s.startswith("#")]
    if not paths:
        raise ValueError("empty input list")
    # multi-process: each process takes a strided slice of the list
    n_proc = int(os.environ.get("TSTA_NUM_PROCESSES", "1"))
    gidx = stride_for_process(list(range(len(paths))))
    paths = stride_for_process(paths)
    if not paths:
        return 0
    seq_sets = [[r.sequence for r in read_records(p)] for p in paths]
    t0 = time.time()
    outs = msa_native.align_seqs_many(seq_sets, _params(args),
                                      kernel=args.kernel, device=args.device)
    wall = time.time() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    used = set()
    for idx, (p, out) in zip(gidx, zip(paths, outs)):
        # names key off the global input index, so sibling processes
        # writing one out-dir cannot collide
        name = os.path.splitext(os.path.basename(p))[0]
        cand, k = name if n_proc == 1 else "%s.%d" % (name, idx), idx
        while cand in used:
            cand = "%s.%d" % (name, k)
            k += n_proc
        used.add(cand)
        msa.write_result(out, os.path.join(args.out_dir, cand + ".txt"))
    if args.json:
        emit_json({"problems": len(outs), "wall_s": round(wall, 4),
                   "out_dir": args.out_dir, "device": args.device,
                   "launches": _launches()})
    return 0


def cmd_batch(args) -> int:
    from tsta_tpu_torch.parallel import batch as pbatch
    mesh = _mesh(args)
    t0 = time.time()
    results = pbatch.align_manifest(args.pairs, _params(args),
                                    traced=args.traced,
                                    out_dir=args.out_dir,
                                    resume=args.resume, mesh=mesh,
                                    device=args.device)
    wall = time.time() - t0
    cells = sum(r["cells"] for r in results)
    emit_json({"pairs": len(results), "wall_s": round(wall, 4),
               "gcups": round(cells / wall / 1e9, 3),
               "launches": _launches()})
    if args.scores:
        with open(args.scores, "w") as f:
            for r in results:
                f.write("%s\t%d\n" % (r["name"], r["score"]))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tsta-torch",
        description="TSTA sequence alignment on PyTorch + CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("psa", help="pairwise global alignment")
    _add_scoring_flags(p)
    p.add_argument("-1", dest="seq1", required=True, help="input FASTA 1")
    p.add_argument("-2", dest="seq2", required=True, help="input FASTA 2")
    p.add_argument("-o", dest="output", default="output.txt",
                   help="alignment output file [output.txt]")
    p.add_argument("--notrace", action="store_true",
                   help="score only (TSTA_psa_notrace equivalent)")
    p.set_defaults(fn=cmd_psa)

    p = sub.add_parser("msa", help="partial-order multiple sequence alignment")
    _add_scoring_flags(p)
    p.add_argument("-i", dest="input", required=True, help="input FASTA")
    p.add_argument("-o", dest="output", default="output.txt",
                   help="MSA output file [output.txt]")
    p.add_argument("--engine", default="compat",
                   choices=["compat", "native"],
                   help="compat = bit-exact vs reference (C, host); native "
                        "= exact int32 DP on the device")
    p.add_argument("--mesh", default=None, metavar="DATAxSEQ",
                   help="device mesh (native engine): each round's columns "
                        "over its seq axis")
    p.set_defaults(fn=cmd_msa)

    p = sub.add_parser("msa-batch",
                       help="many independent MSAs, fusion/DP pipelined "
                            "(native engine)")
    _add_scoring_flags(p)
    p.add_argument("--inputs", required=True,
                   help="text file listing one reads-FASTA per line")
    p.add_argument("--out-dir", required=True,
                   help="directory for per-problem MSA outputs")
    p.set_defaults(fn=cmd_msa_batch)

    p = sub.add_parser("batch", help="batched PSA over many pairs")
    _add_scoring_flags(p)
    p.add_argument("--pairs", required=True,
                   help="TSV manifest: name<TAB>fasta1<TAB>fasta2")
    p.add_argument("--traced", action="store_true")
    p.add_argument("--out-dir", default=None,
                   help="directory for per-pair alignment outputs")
    p.add_argument("--scores", default=None, help="write scores TSV here")
    p.add_argument("--resume", default=None, metavar="JSONL",
                   help="incremental result store; completed pairs are "
                        "skipped on restart (preemption-safe)")
    p.add_argument("--mesh", default=None, metavar="DATAxSEQ",
                   help="device mesh: the pairs shared over its data axis")
    p.set_defaults(fn=cmd_batch)

    if argv is None:
        argv = sys.argv[1:]
    args = ap.parse_args(_merge_negative_values(list(argv)))
    args.kernel = KERNEL_ALIASES.get(args.kernel, args.kernel)
    from tsta_tpu_torch.utils import profiling
    try:
        with profiling.trace(args.profile):
            return args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError,
            DeviceError) as e:
        get_logger().error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
