"""Command-line interface of the port (``tsta-torch``).

    tsta-torch psa  -1 a.fa -2 b.fa [-o out.txt] [--notrace] [flags]
    tsta-torch batch --pairs manifest.tsv [flags]

Same flags and stdout as ``tsta psa`` / ``tsta batch`` of the JAX
package, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain PyTorch versions).  ``--kernel`` takes auto|plain|cuda.  The
``msa`` subcommands and ``--profile`` belong to later slices.
"""

from __future__ import annotations

import argparse
import sys
import time

from tsta_tpu.cli import _merge_negative_values
from tsta_tpu.utils.logging import emit_json, get_logger
from tsta_tpu_torch.device import DEFAULT_DEVICE, DeviceError


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
                   choices=["auto", "plain", "cuda"],
                   help="auto: CUDA kernels for supported parameters; "
                        "plain: the PyTorch row-scan oracle; cuda: kernels "
                        "only")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device [%s]; 'cpu' runs the plain "
                        "versions" % DEFAULT_DEVICE)


def _params(args):
    from tsta_tpu.config import AlignParams
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


def cmd_batch(args) -> int:
    from tsta_tpu_torch.parallel import batch as pbatch
    if args.mesh and args.mesh.lower() != "1x1":
        raise NotImplementedError("--mesh %s: multi-GPU is a later slice "
                                  "of the port" % args.mesh)
    t0 = time.time()
    results = pbatch.align_manifest(args.pairs, _params(args),
                                    traced=args.traced,
                                    out_dir=args.out_dir,
                                    resume=args.resume,
                                    device=args.device)
    wall = time.time() - t0
    cells = sum(r["cells"] for r in results)
    emit_json({"pairs": len(results), "wall_s": round(wall, 4),
               "gcups": round(cells / wall / 1e9, 3)})
    if args.scores:
        with open(args.scores, "w") as f:
            for r in results:
                f.write("%s\t%d\n" % (r["name"], r["score"]))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tsta-torch",
        description="TSTA pairwise alignment on PyTorch + CUDA")
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
                   help="device mesh; only 1x1 (one card) in this slice")
    p.set_defaults(fn=cmd_batch)

    if argv is None:
        argv = sys.argv[1:]
    args = ap.parse_args(_merge_negative_values(list(argv)))
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError,
            DeviceError) as e:
        get_logger().error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
