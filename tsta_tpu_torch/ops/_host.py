"""The POA graph helpers of ``tsta_tpu/native/poa_fast.c`` for the port.

The MSA rounds call two of them every round: ``tsta_poa_hm1`` (the DP's
left boundary) and ``tsta_poa_merge`` (the read's merge into the graph);
the graph's toposort, consensus and MSA rows call the others.  All of
them load the library through ``tsta_tpu.native.build.load_poa``, which
compiles every native source with ``-fopenmp``.  Where the C compiler has
no OpenMP runtime that build fails, and it is retried, a compiler run of
~0.4 s, on every call of every helper.  ``poa_fast.c`` uses no OpenMP,
so :func:`load_poa` then compiles it without, once, into
``build/tsta_tpu_torch/`` (keyed by a hash of the source and the
command), and registers that build as the JAX package's POA library, so
every helper of the process uses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import tsta_tpu.native.build as native_build

_SRC = os.path.join(os.path.dirname(os.path.abspath(native_build.__file__)),
                    "poa_fast.c")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "tsta_tpu_torch")
CFLAGS = ["-O3", "-fPIC", "-shared"]

_LOCK = threading.Lock()


def _build_without_openmp() -> str:
    cc = shutil.which("gcc") or shutil.which("cc") or "cc"
    cmd = [cc] + CFLAGS
    h = hashlib.sha256(" ".join(cmd).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR,
                       "libtsta_poa_host_%s.so" % h.hexdigest()[:16])
    if not os.path.exists(out):
        tmp = "%s.%d.tmp" % (out, os.getpid())
        proc = subprocess.run(cmd + ["-o", tmp, _SRC], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("building poa_fast.c failed:\n%s"
                               % proc.stderr)
        os.replace(tmp, out)
    return out


def load_poa() -> ctypes.CDLL:
    """The POA helper library: ``tsta_tpu.native.build.load_poa()``, or,
    where that build fails, this module's build without OpenMP, then
    registered with ``tsta_tpu.native.build``.  Raises ``RuntimeError``
    when neither builds."""
    with _LOCK:
        try:
            return native_build.load_poa()
        except RuntimeError:
            lib = ctypes.CDLL(_build_without_openmp())
        lp = ctypes.POINTER(ctypes.c_long)
        lib.tsta_poa_toposort.restype = ctypes.c_long
        lib.tsta_poa_toposort.argtypes = [ctypes.c_long] + [lp] * 6
        native_build.setup_poa_symbols(lib)
        with native_build._LOCK:
            native_build._POA_LIB = lib
        return lib
