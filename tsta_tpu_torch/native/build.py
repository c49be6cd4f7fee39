"""Build and load the port's native host libraries.

Three C sources beside this module, copies of the JAX package's, each
with a plain C interface loaded through ``ctypes``:

* ``compat_msa.c``: the compat MSA engine, bit-exact against the
  reference binaries (:func:`load`);
* ``seqio_fast.c``: the FASTA/FASTQ parser (:func:`load_seqio`);
* ``poa_fast.c``: the POA graph helpers of the native MSA engine
  (:func:`load_poa`).

Each compiles on first use into ``build/tsta_tpu_torch/`` beside the
package (the repository root in a checkout, where ``build/`` is
git-ignored), keyed by a hash of the source and the compile command.
As in the JAX package, ``$CC`` names the compiler and
``TSTA_NATIVE_CFLAGS`` adds space-separated flags (for example
``-DTSTA_RMAX=2``, the compat engine's in-degree limit); both are part of
the command, so of the key, and a change rebuilds.  The JAX package's
``TSTA_NATIVE_CACHE`` is not read: the build directory stays the one
above.
``compat_msa.c`` is the one source that calls OpenMP: it compiles with
``-fopenmp`` where the C compiler has an OpenMP runtime, and without it
where it does not; its wavefront then runs on one thread, with the same
output.  No build uses ``-march=native``, so a library built on one
host loads on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "tsta_tpu_torch")
CFLAGS = ["-O3", "-g", "-fPIC", "-shared", "-Wall"]
OPENMP_SOURCES = ("compat_msa.c",)

_LOCK = threading.Lock()
_LIBS: dict = {}
_OPENMP: dict = {}


def compiler() -> str:
    """The C compiler: ``$CC`` when set, else ``gcc`` on ``PATH``, else
    ``cc``."""
    return (os.environ.get("CC") or shutil.which("gcc") or shutil.which("cc")
            or "cc")


def cflags() -> list:
    """:data:`CFLAGS` and the space-separated extras of
    ``TSTA_NATIVE_CFLAGS`` (the JAX package's ``_all_cflags``)."""
    return CFLAGS + os.environ.get("TSTA_NATIVE_CFLAGS", "").split()


def has_openmp(cc: str) -> bool:
    """Whether ``cc -fopenmp`` links a program (once per compiler and
    process)."""
    if cc not in _OPENMP:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "omp.c")
            with open(src, "w") as f:
                f.write("#include <omp.h>\nint main(void) "
                        "{ return omp_get_max_threads() < 1; }\n")
            proc = subprocess.run([cc, "-fopenmp", "-o",
                                   os.path.join(tmp, "omp"), src],
                                  capture_output=True)
        _OPENMP[cc] = proc.returncode == 0
    return _OPENMP[cc]


def build(srcname: str) -> str:
    """Compile ``srcname`` (if its cached library is missing) and return
    the library's path.  Raises ``RuntimeError`` when the compiler
    fails."""
    src = os.path.join(_DIR, srcname)
    cc = compiler()
    cmd = [cc] + cflags()
    if srcname in OPENMP_SOURCES and has_openmp(cc):
        cmd.append("-fopenmp")
    h = hashlib.sha256(" ".join(cmd).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "lib%s_%s.so" % (
        os.path.splitext(srcname)[0], h.hexdigest()[:16]))
    if not os.path.exists(out):
        tmp = "%s.%d.tmp" % (out, os.getpid())
        proc = subprocess.run(cmd + ["-o", tmp, src], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("building %s failed:\n%s"
                               % (srcname, proc.stderr))
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    return out


def _load(srcname: str, setup) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(srcname)
        if lib is None:
            lib = ctypes.CDLL(build(srcname))
            setup(lib)
            _LIBS[srcname] = lib
        return lib


class MsaResultStruct(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int),
        ("cols", ctypes.c_int),
        ("msa", ctypes.POINTER(ctypes.c_char_p)),
        ("consensus", ctypes.c_char_p),
        ("rounds", ctypes.c_int),
        ("last_scores", ctypes.POINTER(ctypes.c_int)),
        ("graph_len", ctypes.POINTER(ctypes.c_int)),
        ("add_len", ctypes.POINTER(ctypes.c_int)),
    ]


def _setup_compat(lib) -> None:
    lib.tsta_msa_run.restype = ctypes.c_int
    lib.tsta_msa_run.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(MsaResultStruct),
    ]
    lib.tsta_msa_free.argtypes = [ctypes.POINTER(MsaResultStruct)]


def load() -> ctypes.CDLL:
    """The compat MSA engine library."""
    return _load("compat_msa.c", _setup_compat)


class SeqIndexStruct(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_long),
        ("cap", ctypes.c_long),
        ("name_off", ctypes.POINTER(ctypes.c_long)),
        ("name_len", ctypes.POINTER(ctypes.c_long)),
        ("com_off", ctypes.POINTER(ctypes.c_long)),
        ("com_len", ctypes.POINTER(ctypes.c_long)),
        ("seq_off", ctypes.POINTER(ctypes.c_long)),
        ("seq_len", ctypes.POINTER(ctypes.c_long)),
        ("qual_off", ctypes.POINTER(ctypes.c_long)),
        ("qual_len", ctypes.POINTER(ctypes.c_long)),
        ("text", ctypes.POINTER(ctypes.c_ubyte)),
        ("text_len", ctypes.c_long),
        ("is_fastq", ctypes.c_int),
        ("err", ctypes.c_char * 256),
    ]


def _setup_seqio(lib) -> None:
    lib.tsta_seqio_parse.restype = ctypes.c_int
    lib.tsta_seqio_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(SeqIndexStruct)]
    lib.tsta_seqio_free.argtypes = [ctypes.POINTER(SeqIndexStruct)]


def load_seqio() -> ctypes.CDLL:
    """The FASTA/FASTQ parser library."""
    return _load("seqio_fast.c", _setup_seqio)


def _setup_poa(lib) -> None:
    lp = ctypes.POINTER(ctypes.c_long)
    ip = ctypes.POINTER(ctypes.c_int)
    ub = ctypes.POINTER(ctypes.c_ubyte)
    lib.tsta_poa_toposort.restype = ctypes.c_long
    lib.tsta_poa_toposort.argtypes = [ctypes.c_long] + [lp] * 6
    lib.tsta_poa_hm1.restype = None
    lib.tsta_poa_hm1.argtypes = [ctypes.c_long, ctypes.c_long, ip, lp,
                                 ctypes.c_long, ctypes.c_long, lp]
    lib.tsta_poa_rank_kahn.restype = ctypes.c_long
    lib.tsta_poa_rank_kahn.argtypes = [ctypes.c_long] + [lp] * 5
    lib.tsta_poa_consensus.restype = ctypes.c_long
    lib.tsta_poa_consensus.argtypes = [ctypes.c_long] + [lp] * 8
    lib.tsta_poa_merge.restype = ctypes.c_long
    lib.tsta_poa_merge.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ub, ip, ip, ip, ub, ctypes.c_long, ctypes.c_long, ip, ip,
        ub, ctypes.c_long, lp]


def load_poa() -> ctypes.CDLL:
    """The POA graph helper library (toposort, consensus, the condensed
    column sort, the DP's left boundary and the merge)."""
    return _load("poa_fast.c", _setup_poa)
