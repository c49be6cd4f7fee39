"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` on first use, one process per
source started together, and linked into one shared library with a plain
C interface, cached under ``build/tsta_tpu_torch/`` beside the package
(the repository root in a checkout, where ``build/`` is git-ignored) and
keyed by a hash of the sources, headers and flags, then loaded with
``ctypes``.  Nothing is compiled or loaded at import, so the CPU tests
import this module on a host without ``nvcc``.

Each launcher checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises :class:`KernelError` when the C side
reports a CUDA error, and adds one to its entry of :data:`launches`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import mmap
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("psa_dp.cu", "psa_dp_traced.cu", "psa_dp_short.cu",
            "psa_dp_diff.cu", "psa_dp_striped.cu", "psa_walk.cu",
            "psa_walk_pair2.cu", "psa_walk_bounded.cu", "poa_dp.cu",
            "poa_walk.cu", "poa_walk_bounded.cu", "dtype_max_probe.cu",
            "walk_probes.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# K1 (psa_dp_score) is the score-only PSA DP of a batch of pairs and
# psa_ring one long pair's over the mesh's shards (Q2-10), both launches of
# the one score-only body that cuts each pair's columns into shards on
# co-resident blocks; psa_ring_linked is one card's launch of the ring
# across cards and processes, that body's linked build; K2 (psa_dp_traced) the traced DP of a batch of pairs
# and psa_dp_chunk a row-chunk of one long traced pair (Q2-7), both
# launches of the one traced body that does the same; psa_dp_short is
# the score-only DP of short pairs, a lane wavefront, one warp a pair;
# psa_dp_diff is the score-only DP by the difference method (int16
# offsets, Q2-9) and psa_dp_striped the one of the striped layout (Q2-11),
# each on K1's schedule of P * D co-resident column shards; K3 is the PSA walk,
# psa_walk_pair2 the walk of two pairs per thread, each on its own window
# ring (Q2-12), and psa_walk_bounded the walk inside one such chunk; poa_dp and
# poa_walk are the MSA round DP (its columns sharded over co-resident
# blocks) and its walk on a single-call round; poa_dp_chunk and
# poa_dp_window are the POA DP kernel's forward chunk and window remat in
# a chunked round, and poa_walk_bounded its walk inside one
# (chunk, window) cell; each of these five with ``_wide`` is its wide form
# (in-degree past 64: 32-bit words with 13-bit pred fields).
# (dtype_max_probe.cu, the narrow-dtype max probe of Q2-17d, is on no
# path: tools/dtype_max_probe.py launches and counts it.)
# walk_probe_a, _b, _c and _e are the walk probes of walk_probes.cu
# (Q2-17a, b, c, e), on no path: tools/walk_probes.py launches them.
KERNELS = ("psa_dp_score", "psa_dp_traced", "psa_dp_chunk", "psa_dp_short",
           "psa_dp_diff", "psa_dp_striped", "psa_walk", "psa_walk_pair2",
           "psa_walk_bounded", "poa_dp", "poa_walk", "poa_dp_chunk",
           "poa_dp_window", "poa_walk_bounded", "psa_ring", "psa_ring_linked",
           "walk_probe_a",
           "walk_probe_b", "walk_probe_c", "walk_probe_e", "poa_dp_wide",
           "poa_walk_wide", "poa_dp_chunk_wide", "poa_dp_window_wide",
           "poa_walk_bounded_wide")
SHORT_MAX_N = 2048   # psa_dp_short's widest pair: JAX's PACK_RMAX x 128
# the bounded walk's phase length (steps a staged window serves;
# psa_walk_stage.cuh; K3 plans its own, psa_walk_layout), the threads a
# walk block may take, and the dynamic shared memory a block may take on
# the H100
WALK_S, MAX_DYNAMIC_SMEM = 64, 232_448
# the two-pair walk's longest phase (csrc/psa_walk_pair2.cu's kPair2MaxS)
PAIR2_MAX_S = 112
WALK_MIN_THREADS, WALK_MAX_THREADS = 64, 256
POA_MAX_IN = 64   # the POA words carry pred indices in 6 bits
POA_WIDE_MAX_IN = 1 << 13   # the wide form's 32-bit words: 13 bits
POA_WIDE_HEAD = 4   # the preds of a row the wide walks stage (kPoaWideHead)
# the POA walks' plan (poa_walk_plan, csrc/poa_walk_stage.cuh): moves a
# phase, the most rows a window takes per move of a phase, threads a block
POA_WALK_S, POA_WALK_ROWS_PER_S, POA_WALK_THREADS = 64, 5, 128
# poa_dp.cu's plan (tsta_poa_dp_layout): threads of a shard's block, the
# fewest and most columns a thread, the most shards before S grows, nodes
# a packet
SHARD_THREADS, SHARD_MIN_S, SHARD_MAX_S, SHARD_MAX, SHARD_T = (
    256, 8, 32, 132, 16)
COOP_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge (CUDA >= 10.1)
# walk_probes.cu's modes, in the order of its enums, and its fixed shapes:
# the band of (a) and (b), 24 whole rows of 1,024 words; (b)'s out width;
# (c)'s band; (e)'s x; the refetch state's start in (a) and (b)
WALK_PROBE_MODES = {
    "a": ("empty", "wr", "rd", "rd3", "cond", "cond_dma"),
    "b": ("while_empty", "fori_empty", "unroll4", "unroll8", "cond_dma",
          "full_unroll8"),
    "c": ("nodma", "decode", "six", "dma119", "dma18"),
    "e": ("db",),
}
PROBE_AB_BAND, PROBE_B_OUT_COLS, PROBE_C_BAND = (24, 1024), 10248, (128, 256)
PROBE_E_X, PROBE_BI0 = (16, 8, 128), -(2 ** 30)
launches = dict.fromkeys(KERNELS, 0)

_LOCK = threading.Lock()
_LIB = None
_POA_LIMITS: dict = {}   # (card, T, S, wide) -> poa_dp's co-resident limit
build_info: dict = {}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build",
                          "tsta_tpu_torch")


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else the CUDA toolkit's (``CUDA_HOME``, by
    default ``/usr/local/cuda``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for c in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if c and os.path.exists(c):
            return c
    raise KernelError("nvcc not found on PATH or under CUDA_HOME")


def build() -> str:
    """Compile the kernels (if the cached library is missing) and return
    the library's path.  Fills :data:`build_info` with the path, the
    build seconds (0 when cached) and nvcc's resource report."""
    nvcc = nvcc_path()
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    h = hashlib.sha256(" ".join([nvcc] + NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libtsta_torch_%s.so" % h.hexdigest()[:16])
    log = out + ".log"
    secs = 0.0
    if not os.path.exists(out):
        tmp = "%s.%d.tmp" % (out, os.getpid())
        objs = ["%s.%s.o" % (tmp, os.path.splitext(os.path.basename(s))[0])
                for s in srcs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", s, "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        report = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, r) for s, p, r in zip(srcs, procs, report)
                  if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp]
                                  + objs, capture_output=True, text=True)
            if link.returncode != 0:
                failed = [("link", link.returncode,
                           link.stdout + link.stderr)]
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        secs = time.perf_counter() - t0
        if failed:
            raise KernelError("nvcc failed:\n" + "\n".join(
                "%s (%d):\n%s" % f for f in failed))
        with open(log, "w") as f:
            f.write("".join(report))
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    ptxas = ""
    if os.path.exists(log):
        with open(log) as f:
            ptxas = f.read()
    build_info.update(path=out, seconds=secs, nvcc=nvcc, ptxas=ptxas)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.tsta_psa_dp.restype = ci
            lib.tsta_psa_dp.argtypes = [vp] * 3 + [ci] * 11 + [vp] * 5
            lib.tsta_psa_dp_scratch_words.restype = ci
            lib.tsta_psa_dp_scratch_words.argtypes = [ci, ci]
            lib.tsta_psa_dp_max_blocks.restype = ci
            lib.tsta_psa_dp_max_blocks.argtypes = [ci, ci]
            lib.tsta_psa_dp_linked.restype = ci
            lib.tsta_psa_dp_linked.argtypes = [vp] * 3 + [ci] * 9 + [
                vp] * 4 + [ci] * 2 + [vp] * 5
            lib.tsta_psa_dp_linked_max_blocks.restype = ci
            lib.tsta_psa_dp_linked_max_blocks.argtypes = [ci, ci]
            lib.tsta_host_register.restype = ci
            lib.tsta_host_register.argtypes = [vp, ctypes.c_size_t]
            lib.tsta_host_unregister.restype = ci
            lib.tsta_host_unregister.argtypes = [vp]
            lib.tsta_host_device_ptr.restype = ci
            lib.tsta_host_device_ptr.argtypes = [vp, ctypes.POINTER(vp)]
            lib.tsta_psa_dp_layout.restype = None
            lib.tsta_psa_dp_layout.argtypes = [ci, ci, ci] + [
                ctypes.POINTER(ci)] * 4
            lib.tsta_psa_dp_traced.restype = ci
            lib.tsta_psa_dp_traced.argtypes = [vp] * 3 + [ci] * 8 + [
                vp] * 7 + [ci] * 3 + [vp] * 4
            lib.tsta_psa_dp_traced_scratch_words.restype = ci
            lib.tsta_psa_dp_traced_scratch_words.argtypes = [ci]
            lib.tsta_psa_dp_traced_max_blocks.restype = ci
            lib.tsta_psa_dp_traced_max_blocks.argtypes = [ci, ci]
            lib.tsta_psa_dp_traced_layout.restype = None
            lib.tsta_psa_dp_traced_layout.argtypes = [ci, ci, ci] + [
                ctypes.POINTER(ci)] * 4
            lib.tsta_psa_dp_short.restype = ci
            lib.tsta_psa_dp_short.argtypes = [vp] * 4 + [ci] * 9 + [vp] * 4
            lib.tsta_psa_dp_short_width.restype = ci
            lib.tsta_psa_dp_short_width.argtypes = [ci] * 2
            lib.tsta_psa_dp_short_width_built.restype = ci
            lib.tsta_psa_dp_short_width_built.argtypes = [ci]
            lib.tsta_psa_dp_short_layout.restype = ci
            lib.tsta_psa_dp_short_layout.argtypes = [ci, ci,
                                                     ctypes.POINTER(ci)]
            lib.tsta_psa_dp_diff.restype = ci
            lib.tsta_psa_dp_diff.argtypes = [vp] * 3 + [ci] * 12 + [vp] * 5
            lib.tsta_psa_dp_diff_scratch_words.restype = ci
            lib.tsta_psa_dp_diff_scratch_words.argtypes = [ci] * 3
            lib.tsta_psa_dp_diff_max_blocks.restype = ci
            lib.tsta_psa_dp_diff_max_blocks.argtypes = [ci] * 3
            lib.tsta_psa_dp_diff_plan.restype = None
            lib.tsta_psa_dp_diff_plan.argtypes = [ci] * 3 + [
                ctypes.POINTER(ci)] * 5
            lib.tsta_psa_dp_striped.restype = ci
            lib.tsta_psa_dp_striped.argtypes = [vp] * 3 + [ci] * 10 + [vp] * 5
            lib.tsta_psa_dp_striped_max_blocks.restype = ci
            lib.tsta_psa_dp_striped_max_blocks.argtypes = [ci, ci]
            lib.tsta_dtype_max_probe.restype = ci
            lib.tsta_dtype_max_probe.argtypes = [vp] * 3 + [ci] * 4 + [vp]
            for k in "abc":
                fn = getattr(lib, "tsta_walk_probe_" + k)
                fn.restype = ci
                fn.argtypes = [vp, vp] + [ci] * 5 + [vp]
            lib.tsta_walk_probe_e.restype = ci
            lib.tsta_walk_probe_e.argtypes = [vp, vp, ci, vp]
            lib.tsta_psa_walk_bounded.restype = ci
            lib.tsta_psa_walk_bounded.argtypes = [vp, vp] + [ci] * 7 + [
                vp, vp, ci, vp]
            lib.tsta_psa_walk.restype = ci
            lib.tsta_psa_walk.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, ci,
                                          ci, vp]
            lib.tsta_psa_walk_layout.restype = None
            lib.tsta_psa_walk_layout.argtypes = [ci, ci] + [
                ctypes.POINTER(ci)] * 2
            lib.tsta_psa_walk_pair2.restype = ci
            lib.tsta_psa_walk_pair2.argtypes = [vp, vp, ci, ci, ci, vp, ci,
                                                vp, ci, ci, vp]
            lib.tsta_psa_walk_pair2_bytes.restype = ci
            lib.tsta_psa_walk_pair2_bytes.argtypes = [ci]
            lib.tsta_poa_dp.restype = ci
            lib.tsta_poa_dp.argtypes = [vp] * 5 + [ci] * 14 + [vp] * 4 + [
                ci] * 5 + [vp] * 5
            lib.tsta_poa_dp_layout.restype = None
            lib.tsta_poa_dp_layout.argtypes = [ci] + [ctypes.POINTER(ci)] * 4
            lib.tsta_poa_dp_max_blocks.restype = ci
            lib.tsta_poa_dp_max_blocks.argtypes = [ci, ci, ci]
            lib.tsta_poa_walk.restype = ci
            lib.tsta_poa_walk.argtypes = [vp, vp, vp] + [ci] * 4 + [
                vp, vp] + [ci] * 3 + [vp]
            lib.tsta_poa_walk_bounded.restype = ci
            lib.tsta_poa_walk_bounded.argtypes = [vp, vp] + [ci] * 8 + [
                vp, vp, vp] + [ci] * 3 + [vp]
            _LIB = lib
        return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError("%s on %s, expected %s" % (name, t.device, dev))
    if t.dtype != dtype:
        raise ValueError("%s is %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError("%s launch failed: CUDA error %d (%s)"
                          % (what, rc, torch.cuda.get_device_name()))


def psa_dp_layout(P: int, n_pad: int, sms: int) -> tuple:
    """(D, C, W, T): the shards, columns per shard, columns per thread and
    rows per packet ``psa_dp.cu`` plans for a score-only launch over P
    pairs of ``n_pad`` columns on a card of ``sms`` SMs, read from the
    built library (``psa_diff.score_plan`` is its twin)."""
    out = [ctypes.c_int() for _ in range(4)]
    _lib().tsta_psa_dp_layout(P, n_pad, sms, *map(ctypes.byref, out))
    return tuple(v.value for v in out)


def psa_dp_max_blocks(C: int, T: int, dev) -> int:
    """The most score-only DP blocks (shards of C columns, T-row packets)
    the card ``dev`` holds resident at once."""
    with torch.cuda.device(dev):
        limit = _lib().tsta_psa_dp_max_blocks(C, T)
    if limit < 0:
        _raise_on(-limit, "psa_dp occupancy query")
    return limit


def psa_dp_striped_max_blocks(C: int, T: int, dev) -> int:
    """The most striped-layout DP blocks (shards of C columns, T-row
    packets) the card ``dev`` holds resident at once."""
    with torch.cuda.device(dev):
        limit = _lib().tsta_psa_dp_striped_max_blocks(C, T)
    if limit < 0:
        _raise_on(-limit, "psa_dp_striped occupancy query")
    return limit


def _launch_shards(what, dev, P, D, comm, out, scratch_words, call, limit,
                   at) -> None:
    """One launch of a sharded score-only body (K1's, the ring's, the
    striped DP's or the difference method's) over P pairs of D shards,
    writing ``out`` ((P, D, 2) int32) and, when given, ``comm`` ((P, D,
    row blocks, 2T) int32 packets): the flags (zero, one a packet slot)
    and ``scratch_words`` 32-bit words of scratch a shard are allocated
    here, and ``call(comm, flags, out, scratch, stream)`` (pointers, None
    where absent) calls the C entry point and returns its code.  A
    cooperative launch the card cannot hold raises :class:`KernelError`
    with ``limit()``, the most blocks it holds at ``at``; any other error
    code raises too."""
    flags = None
    if comm is not None:
        flags = torch.zeros(comm.shape[:3], dtype=torch.int32, device=dev)
    scratch = (torch.empty((P, D, scratch_words), dtype=torch.int32,
                           device=dev) if scratch_words else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = call(ptr(comm), ptr(flags), out.data_ptr(), ptr(scratch),
                  _stream(dev))
    if rc == COOP_TOO_LARGE:
        raise KernelError(
            "%s: %d pairs of %d shards need %d co-resident blocks, but %s "
            "holds at most %d at %s (cooperative launch)"
            % (what, P, D, P * D, torch.cuda.get_device_name(dev), limit(),
               at))
    _raise_on(rc, what)


def _score_entry(a, b, lens, params, full, D, C, T, striped=False) -> tuple:
    """The score-only body's C entry point over P pairs (``a``: (P,
    n_pad), ``tsta_psa_dp``, or with ``striped`` (P, Sp, 128) tiles, n_pad
    = Sp * 128, ``tsta_psa_dp_striped``; ``b``: (P, m_stride), ``lens``:
    (P, 2)) at D shards of C columns and T-row packets, as
    :func:`_launch_shards` takes it: (scratch words, call, limit, at).
    ``full`` runs every padded cell (the ring), else each pair's real
    extent (K1, the striped DP)."""
    dev = a.device
    P = a.shape[0]
    n_pad = a[0].numel()
    m_stride = b.shape[1]
    lib = _lib()
    m_, x_, e_, o_ = params

    def call(comm, flags, out, scratch, stream):
        if striped:
            return lib.tsta_psa_dp_striped(
                a.data_ptr(), b.data_ptr(), lens.data_ptr(), P, n_pad // 128,
                m_stride, m_, x_, e_, o_, D, C, T, comm, flags, out, scratch,
                stream)
        return lib.tsta_psa_dp(
            a.data_ptr(), b.data_ptr(), lens.data_ptr(), P, n_pad, m_stride,
            m_, x_, e_, o_, int(full), D, C, T, comm, flags, out, scratch,
            stream)

    def limit():
        return (psa_dp_striped_max_blocks if striped
                else psa_dp_max_blocks)(C, T, dev)

    return (lib.tsta_psa_dp_scratch_words(C, T), call, limit,
            "C = %d columns, T = %d rows" % (C, T))


def _check_pairs(what, a, b, lens, score, corner, a_shape):
    """The checks every score-only wrapper makes: CUDA tensors, ``a`` of
    ``a_shape``, b (B, m_stride), lens (B, 2), score/corner (B,)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("%s kernel needs CUDA tensors, got %s" % (what, dev))
    B = a_shape[0]
    m_stride = b.shape[1]
    _check(a, "a", torch.uint8, a_shape, dev)
    _check(b, "b", torch.uint8, (B, m_stride), dev)
    _check(lens, "lens", torch.int32, (B, 2), dev)
    _check(score, "score", torch.int32, (B,), dev)
    _check(corner, "corner", torch.int32, (B,), dev)
    if B < 1 or min(a_shape) < 1 or m_stride < 1:
        raise ValueError("%s: %d pairs of %s x m_stride %d"
                         % (what, B, a_shape[1:], m_stride))


def _score_shards(what, P, n_pad, dev, D, T) -> tuple:
    """(D, C, T) of a score-only launch (K1's or the striped DP's) over P
    pairs of n_pad columns: the plan (:func:`psa_dp_layout`), or at a
    forced ``D`` C = n_pad / D rounded up, which must give D shards, and
    a forced ``T``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_d, C, _, plan_t = psa_dp_layout(P, n_pad, sms)
    if D is None:
        D = plan_d
    else:
        C = -(-n_pad // max(D, 1))
        if D < 1 or -(-n_pad // C) != D:
            raise ValueError("%s: %d columns do not make %d shards"
                             % (what, n_pad, D))
    T = plan_t if T is None else T
    if T < 1:
        raise ValueError("%s: T %d rows a packet" % (what, T))
    return D, C, T


def _score_pairs(what, a, b, score, corner, D, T, entry) -> None:
    """A launch over P pairs of a sharded score-only body at D shards and
    T-row packets, each pair over its real extent, ``entry`` its C entry
    point as :func:`_launch_shards` takes it: the packets (D >= 2) and the
    shards' (best, corner) allocated here, the latter reduced by a max
    into ``score``/``corner``."""
    B, m_stride = b.shape
    comm = None
    if D >= 2:
        comm = torch.empty((B, D, -(-m_stride // T), 2 * T),
                           dtype=torch.int32, device=a.device)
    out = torch.empty((B, D, 2), dtype=torch.int32, device=a.device)
    _launch_shards(what, a.device, B, D, comm, out, *entry)
    torch.amax(out[:, :, 0], 1, out=score)
    torch.amax(out[:, :, 1], 1, out=corner)


def psa_dp(a, b, lens, params, score, corner, *, D=None, T=None) -> tuple:
    """Launch the score-only DP (K1) over B pairs, each over its real
    extent: ``a``: (B, n_stride) uint8, ``b``: (B, m_stride) uint8,
    ``lens``: (B, 2) int32 real (n, m); ``score``/``corner``: (B,) int32
    outputs, the max over each pair's cells and H(m-1, n-1).  Each pair's
    columns are cut into D shards of C columns, one co-resident block
    each, T rows a packet: the kernel's plan for B pairs on this card
    (:func:`psa_dp_layout`); ``D`` (C = n_stride / D rounded up, which
    must give D shards) and ``T`` override it, for tests and sweeps.  D =
    1 launches B blocks, any B; D >= 2 is a cooperative launch of B * D
    blocks, which raises :class:`KernelError`, without launching, past the
    card's co-resident limit.  The shards' (best, corner) are reduced by a
    max after the launch.  Returns the (D, C, T) it ran.  The traced DP is
    :func:`psa_dp_traced`."""
    _check_pairs("psa_dp", a, b, lens, score, corner, tuple(a.shape))
    D, C, T = _score_shards("psa_dp", a.shape[0], a.shape[1], a.device, D, T)
    _score_pairs("psa_dp", a, b, score, corner, D, T,
                 _score_entry(a, b, lens, params, False, D, C, T))
    launches["psa_dp_score"] += 1
    return D, C, T


def psa_dp_short_width(n: int, m: int) -> int:
    """The strip width ``psa_dp_short.cu``'s plan gives an n x m pair, read
    from the built library (``psa_pallas.short_width`` is its twin)."""
    return _lib().tsta_psa_dp_short_width(n, m)


def psa_dp_short_layout(B: int, dev, per_sm=None) -> tuple:
    """(blocks, blocks an SM, the most an SM holds): the persistent blocks
    of four warps a ``psa_dp_short`` launch over B pairs takes on the card
    ``dev``, at the plan's blocks an SM or ``per_sm`` (capped at what an SM
    holds)."""
    resident = ctypes.c_int()
    with torch.cuda.device(dev):
        blocks = _lib().tsta_psa_dp_short_layout(B, per_sm or 0,
                                                 ctypes.byref(resident))
    if blocks < 0:
        _raise_on(-blocks, "psa_dp_short occupancy query")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return blocks, min(-(-blocks // sms), resident.value), resident.value


def psa_dp_short(a, b, lens, params, score, corner, *, W=None,
                 per_sm=None) -> tuple:
    """Launch the short-pair DP (a lane wavefront, one warp a pair) over B
    pairs, each over its real extent: ``a``: (B, n_stride) uint8, n_stride
    <= :data:`SHORT_MAX_N`, ``b``: (B, m_stride) uint8, ``lens``: (B, 2)
    int32 real (n, m); ``score``/``corner``: (B,) int32 outputs.  The warps
    are persistent and take the pairs longest first (one argsort of n*m on
    the card); each pair runs at its plan's strip width
    (:func:`psa_dp_short_width`), or every pair at ``W``, for tests; on
    the plan's blocks an SM, or ``per_sm``, for sweeps.  One launch;
    returns :func:`psa_dp_short_layout`'s (blocks, blocks an SM, the most
    an SM holds)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("psa_dp_short kernel needs CUDA tensors, got %s"
                         % dev)
    B, n_stride = a.shape
    m_stride = b.shape[1]
    _check(a, "a", torch.uint8, (B, n_stride), dev)
    _check(b, "b", torch.uint8, (B, m_stride), dev)
    _check(lens, "lens", torch.int32, (B, 2), dev)
    _check(score, "score", torch.int32, (B,), dev)
    _check(corner, "corner", torch.int32, (B,), dev)
    if not 1 <= n_stride <= SHORT_MAX_N:
        raise ValueError("psa_dp_short takes at most %d columns, got %d"
                         % (SHORT_MAX_N, n_stride))
    lib = _lib()
    if W is not None and not lib.tsta_psa_dp_short_width_built(W):
        raise ValueError("psa_dp_short: no build of strip width %s" % W)
    if per_sm is not None and per_sm < 1:
        raise ValueError("psa_dp_short: %d blocks an SM" % per_sm)
    layout = psa_dp_short_layout(B, dev, per_sm)
    order = torch.argsort(lens[:, 0].to(torch.int64) * lens[:, 1],
                          descending=True)
    scratch = torch.empty((2 + 2 * layout[0] * 4 * m_stride,),
                          dtype=torch.int32, device=dev)
    m_, x_, e_, o_ = params
    with torch.cuda.device(dev):
        rc = lib.tsta_psa_dp_short(
            a.data_ptr(), b.data_ptr(), lens.data_ptr(), order.data_ptr(), B,
            n_stride, m_stride, m_, x_, e_, o_, W or 0, layout[0],
            score.data_ptr(), corner.data_ptr(), scratch.data_ptr(),
            _stream(dev))
    _raise_on(rc, "psa_dp_short")
    launches["psa_dp_short"] += 1
    return layout


def psa_dp_diff_plan(P: int, n_pad: int, sms: int) -> tuple:
    """(D, C, W, G, T): the shards, columns a shard, columns a thread,
    columns a segment and rows a packet ``psa_dp_diff.cu`` plans for P
    pairs of ``n_pad`` columns on a card of ``sms`` SMs, read from the
    built library (``psa_diff.diff_plan`` is its twin)."""
    out = [ctypes.c_int() for _ in range(5)]
    _lib().tsta_psa_dp_diff_plan(P, n_pad, sms, *map(ctypes.byref, out))
    return tuple(v.value for v in out)


def psa_dp_diff_max_blocks(W: int, G: int, T: int, dev) -> int:
    """The most difference-method DP blocks (W columns a thread in segments
    of G, T-row packets) the card ``dev`` holds resident at once."""
    with torch.cuda.device(dev):
        limit = _lib().tsta_psa_dp_diff_max_blocks(W, G, T)
    if limit < 0:
        _raise_on(-limit, "psa_dp_diff occupancy query")
    return limit


def psa_dp_diff(a, b, lens, params, score, corner, *, D=None,
                T=None) -> tuple:
    """Launch the difference-method DP (H/E as int16 offsets from
    per-segment int32 anchors) over B pairs, each over its real extent:
    ``a``: (B, n_stride) uint8, n_stride a multiple of 4, ``b``: (B,
    m_stride) uint8, ``lens``: (B, 2) int32 real (n, m);
    ``score``/``corner``: (B,) int32 outputs.  Each pair's columns are cut
    into D shards of C columns, one co-resident block each, W columns a
    thread in segments of G, T rows a packet: the kernel's plan for B
    pairs on this card (:func:`psa_dp_diff_plan`); ``D``
    (``psa_diff.diff_shards``: C whole segments, which must give D shards)
    and ``T`` override it, for tests and sweeps.  D = 1 launches B blocks,
    any B; D >= 2 is a cooperative launch of B * D blocks, which raises
    :class:`KernelError`, without launching, past the card's co-resident
    limit.  ``params`` must pass ``psa_diff.supports_params_int16`` (D <=
    57); the C side refuses the rest without launching.  Returns the (D,
    C, W, G, T) it ran."""
    from tsta_tpu_torch.ops.psa_diff import diff_shards
    _check_pairs("psa_dp_diff", a, b, lens, score, corner, tuple(a.shape))
    dev = a.device
    B, n_stride = a.shape
    m_stride = b.shape[1]
    if n_stride % 4 or a.data_ptr() % 4:
        raise ValueError("psa_dp_diff reads a in 4-byte words: n_stride %d"
                         % n_stride)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = psa_dp_diff_plan(B, n_stride, sms)
    if D is None:
        D, C, W, G, _ = plan
    else:
        C, W, G = diff_shards(n_stride, D)
    T = plan[4] if T is None else T
    if T < 1:
        raise ValueError("psa_dp_diff: T %d rows a packet" % T)
    lib = _lib()

    def call(comm, flags, out, scratch, stream):
        return lib.tsta_psa_dp_diff(
            a.data_ptr(), b.data_ptr(), lens.data_ptr(), B, n_stride,
            m_stride, *params, D, C, W, G, T, comm, flags, out, scratch,
            stream)

    _score_pairs("psa_dp_diff", a, b, score, corner, D, T, (
        lib.tsta_psa_dp_diff_scratch_words(W, G, T), call,
        lambda: psa_dp_diff_max_blocks(W, G, T, dev),
        "W = %d columns a thread, G = %d, T = %d rows" % (W, G, T)))
    launches["psa_dp_diff"] += 1
    return D, C, W, G, T


def psa_dp_striped(a_tile, b, lens, params, score, corner, *, D=None,
                   T=None) -> tuple:
    """Launch the striped-layout DP over B pairs, each over its real
    extent: ``a_tile``: (B, Sp, 128) uint8, column j of a pair at [j % Sp,
    j // Sp]; ``b``: (B, m_stride) uint8; ``lens``: (B, 2) int32 real (n,
    m); ``score``/``corner``: (B,) int32 outputs.  K1's schedule on the
    tile, which the kernel reads itself: each pair's n_pad = Sp * 128
    columns in D shards of C columns, T rows a packet, K1's plan
    (:func:`psa_dp_layout`) or a forced ``D`` and ``T`` as
    :func:`psa_dp` takes them; D >= 2 past the card's co-resident limit
    raises :class:`KernelError` without launching.  Returns the (D, C, T)
    it ran."""
    if a_tile.dim() != 3 or a_tile.shape[2] != 128 or a_tile.shape[1] < 1:
        raise ValueError("a_tile must be (B, Sp, 128), got %s"
                         % (tuple(a_tile.shape),))
    _check_pairs("psa_dp_striped", a_tile, b, lens, score, corner,
                 tuple(a_tile.shape))
    B, sp = a_tile.shape[:2]
    D, C, T = _score_shards("psa_dp_striped", B, sp * 128, a_tile.device,
                            D, T)
    _score_pairs("psa_dp_striped", a_tile, b, score, corner, D, T,
                 _score_entry(a_tile, b, lens, params, False, D, C, T,
                              striped=True))
    launches["psa_dp_striped"] += 1
    return D, C, T


def _check_walk(plane, nm, words, counts, what: str):
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError("%s kernel needs CUDA tensors, got %s" % (what, dev))
    if plane.dim() != 3 or words.dim() != 2:
        raise ValueError("%s: plane must be (P, m_pad, n_pad) and words "
                         "(P, n_words)" % what)
    P, m_pad, n_pad = plane.shape
    n_words = words.shape[1]
    _check(plane, "plane", torch.uint8, (P, m_pad, n_pad), dev)
    _check(nm, "nm", torch.int32, (P, 2), dev)
    _check(words, "words", torch.int32, (P, n_words), dev)
    _check(counts, "counts", torch.int32, (P,), dev)
    if n_words < (m_pad + n_pad + 15) // 16 + 1:
        raise ValueError("words too short for a (%d, %d) plane"
                         % (m_pad, n_pad))
    return (plane.data_ptr(), nm.data_ptr(), P, m_pad, n_pad,
            words.data_ptr(), n_words, counts.data_ptr(), _stream(dev))


def _check_copies(n_pad: int, what: str, *tensors) -> None:
    """A walk on the window ring stages its plane in 16-byte copies: n_pad
    a multiple of 16 and 16-byte aligned tensors (every route's n_pad is
    a multiple of 128), else ValueError."""
    if n_pad % 16 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("%s stages the plane in 16-byte copies: n_pad %d "
                         "must be a multiple of 16 and the planes 16-byte "
                         "aligned" % (what, n_pad))


def walk_ring_bytes(S: int) -> int:
    """Bytes of a walk's window ring at phase length S: two windows of (2S
    + 1) x (2S + 16) bytes (``csrc/psa_walk_stage.cuh``)."""
    return 2 * (2 * S + 1) * (2 * S + 16)


def pair2_guard(S: int) -> int:
    """Bytes before each pair's two windows in the two-pair walk's shared
    memory, which its reads past the window's first row land in
    (``csrc/psa_walk_pair2.cu``'s ``pair2_guard``)."""
    return 2 * S + 32


def pair2_bytes(S: int) -> int:
    """Bytes of the two-pair walk's shared memory at phase length S: a ring
    a pair, each after its guard (``csrc/psa_walk_pair2.cu``,
    ``tsta_psa_walk_pair2_bytes``)."""
    return 2 * (pair2_guard(S) + walk_ring_bytes(S))


def walk_s(S: int | None = None, nbytes=walk_ring_bytes) -> int:
    """A walk's phase length: ``S`` (forced by a test or a sweep) or
    :data:`WALK_S`; a multiple of 8 whose shared memory, ``nbytes(S)``
    (the two windows of one ring unless said), fits a block, else
    ValueError."""
    S = WALK_S if S is None else int(S)
    if S < 8 or S % 8 or nbytes(S) > MAX_DYNAMIC_SMEM:
        raise ValueError("walk phase length S must be a multiple of 8 whose "
                         "windows fit %d bytes, got %d"
                         % (MAX_DYNAMIC_SMEM, S))
    return S


def pair2_s(S: int | None = None) -> int:
    """The two-pair walk's phase length: :func:`walk_s` over its shared
    memory (:func:`pair2_bytes`), and at most :data:`PAIR2_MAX_S`, since
    its step keeps a cell offset's step (2S + 17) in a byte; else
    ValueError."""
    S = walk_s(S, pair2_bytes)
    if S > PAIR2_MAX_S:
        raise ValueError("the two-pair walk's phase length S is at most %d, "
                         "got %d" % (PAIR2_MAX_S, S))
    return S


def _layout(fn, P: int, sms: int) -> tuple:
    out = [ctypes.c_int() for _ in range(2)]
    fn(P, sms, *map(ctypes.byref, out))
    return tuple(v.value for v in out)


def psa_walk_layout(P: int, sms: int) -> tuple:
    """(S, threads): K3's plan for P pairs on a card of ``sms`` SMs, read
    from the built library: 128 threads, S = 64 up to one pair an SM,
    else 32."""
    return _layout(_lib().tsta_psa_walk_layout, P, sms)


def _walk_plan(plane, S, threads, what: str, check_s=walk_s) -> tuple:
    """(S, threads) of a walk launch over ``plane``: K3's plan
    (:func:`psa_walk_layout`) for its pairs on this card where not forced,
    S checked by ``check_s`` and threads here."""
    if S is None or threads is None:
        sms = torch.cuda.get_device_properties(plane.device) \
            .multi_processor_count
        plan_s, plan_threads = psa_walk_layout(plane.shape[0], sms)
        S = plan_s if S is None else S
        threads = plan_threads if threads is None else threads
    S, threads = check_s(S), int(threads)
    if threads % 32 or not WALK_MIN_THREADS <= threads <= WALK_MAX_THREADS:
        raise ValueError("%s: threads must be a multiple of 32 in [%d, %d], "
                         "got %d" % (what, WALK_MIN_THREADS, WALK_MAX_THREADS,
                                     threads))
    return S, threads


def psa_walk(plane, nm, words, counts, *, S=None, threads=None) -> None:
    """Launch the walk kernel (one block per pair on the window ring, S
    steps a phase, ``threads`` a block: :func:`psa_walk_layout`'s plan
    unless forced) over a (P, m_pad, n_pad) uint8 code plane; ``nm``: (P,
    2) int32 real (n, m); ``words``: (P, n_words) int32 and ``counts``:
    (P,) int32 outputs."""
    args = _check_walk(plane, nm, words, counts, "psa_walk")
    _check_copies(plane.shape[2], "psa_walk", plane)
    S, threads = _walk_plan(plane, S, threads, "psa_walk")
    _raise_on(_lib().tsta_psa_walk(*args[:-1], S, threads, args[-1]),
              "psa_walk")
    launches["psa_walk"] += 1


def psa_walk_pair2(plane, nm, words, counts, *, S=None, threads=None) -> None:
    """Launch the two-pair walk (block q walks pairs 2q and 2q + 1, one
    thread both chains, each pair on its own window ring; S steps a phase
    and ``threads`` a block: K3's plan, :func:`psa_walk_layout`, unless
    forced, S checked by :func:`pair2_s`) over a (P, m_pad, n_pad) uint8
    code plane, P even; the arguments and outputs of :func:`psa_walk`."""
    args = _check_walk(plane, nm, words, counts, "psa_walk_pair2")
    if plane.shape[0] < 2 or plane.shape[0] % 2:
        raise ValueError("psa_walk_pair2 walks an even number of pairs, got "
                         "%d" % plane.shape[0])
    _check_copies(plane.shape[2], "psa_walk_pair2", plane)
    S, threads = _walk_plan(plane, S, threads, "psa_walk_pair2", pair2_s)
    _raise_on(_lib().tsta_psa_walk_pair2(*args[:-1], S, threads, args[-1]),
              "psa_walk_pair2")
    launches["psa_walk_pair2"] += 1


def psa_dp_traced_layout(P: int, n_pad: int, sms: int) -> tuple:
    """(D, C, W, T): the shards, columns per shard, columns per thread and
    rows per packet ``psa_dp_traced.cu`` plans for P pairs of ``n_pad``
    columns on a card of ``sms`` SMs, read from the built library."""
    out = [ctypes.c_int() for _ in range(4)]
    _lib().tsta_psa_dp_traced_layout(P, n_pad, sms, *map(ctypes.byref, out))
    return tuple(v.value for v in out)


def psa_dp_chunk_layout(n_pad: int, sms: int) -> tuple:
    """(D, C, W, T): the plan ``psa_dp_traced.cu`` takes for one pair's
    row-chunk of ``n_pad`` columns, its layout at P = 1."""
    return psa_dp_traced_layout(1, n_pad, sms)


def psa_dp_traced_max_blocks(C: int, T: int, dev) -> int:
    """The most traced-DP blocks (shards of C columns, T-row packets) the
    card ``dev`` holds resident at once."""
    with torch.cuda.device(dev):
        limit = _lib().tsta_psa_dp_traced_max_blocks(C, T)
    if limit < 0:
        _raise_on(-limit, "psa_dp_traced occupancy query")
    return limit


def _traced_launch(what, a, b, lens, row_base, params, h_in, e_in, h_out,
                   e_out, best, corner, plane, D, T) -> tuple:
    """One launch of the traced body over P pairs at the kernel's plan
    for them on this card, or at ``D`` shards (C = n_pad / D rounded up
    to 4, which must give D shards) and ``T`` rows a packet (1-256): the
    packets and the scratch allocated here, D = 1 an ordinary launch, D
    >= 2 a cooperative one; a refused launch raises
    :class:`KernelError`.  Returns the (D, C, T) it ran."""
    dev = a.device
    P, n_pad = a.shape
    rows = b.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_d, C, _, plan_t = psa_dp_traced_layout(P, n_pad, sms)
    if D is None:
        D = plan_d
    else:
        C = (-(-n_pad // max(D, 1)) + 3) // 4 * 4
        if D < 1 or -(-n_pad // C) != D:
            raise ValueError("%s: %d columns do not make %d shards of a "
                             "multiple of 4" % (what, n_pad, D))
    T = plan_t if T is None else T
    if not 1 <= T <= 256:
        raise ValueError("%s: T %d outside 1..256" % (what, T))
    mb = -(-rows // T)
    lib = _lib()
    comm = flags = None
    if D >= 2:
        comm = torch.empty((P, D, mb, 3 * T), dtype=torch.int32, device=dev)
        flags = torch.zeros((P, D, mb), dtype=torch.int32, device=dev)
    sw = lib.tsta_psa_dp_traced_scratch_words(C)
    scratch = (torch.empty((P, D, sw), dtype=torch.int32, device=dev) if sw
               else None)
    m_, x_, e_, o_ = params

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.tsta_psa_dp_traced(
            a.data_ptr(), b.data_ptr(), lens.data_ptr(), P, n_pad, rows,
            row_base, m_, x_, e_, o_, ptr(h_in), ptr(e_in), ptr(h_out),
            ptr(e_out), best.data_ptr(), corner.data_ptr(), plane.data_ptr(),
            D, C, T, ptr(comm), ptr(flags), ptr(scratch), _stream(dev))
    if rc == COOP_TOO_LARGE:
        raise KernelError(
            "%s: %d pairs of %d shards need %d co-resident blocks, but %s "
            "holds at most %d at C = %d columns, T = %d rows (cooperative "
            "launch)" % (what, P, D, P * D, torch.cuda.get_device_name(dev),
                         psa_dp_traced_max_blocks(C, T, dev), C, T))
    _raise_on(rc, what)
    return D, C, T


def psa_dp_traced(a, b, lens, params, score, corner, plane, *, D=None,
                  T=None) -> tuple:
    """Launch the traced DP over P pairs of one padded shape, every padded
    cell from row 0: ``a``: (P, n_pad) uint8, n_pad a multiple of 4,
    ``b``: (P, m_pad) uint8, ``lens``: (P, 2) int32 real (n, m); outputs
    ``score``/``corner`` (P,) int32 (the max over every cell of the pair,
    H(m-1, n-1)) and ``plane`` (P, m_pad, n_pad) uint8, every cell's
    code.  Each pair's columns are cut into D shards of C columns, one
    co-resident block each, T rows a packet: the kernel's plan for P pairs
    on this card (:func:`psa_dp_traced_layout`); ``D`` and ``T`` override
    it, for tests and sweeps (:func:`_traced_launch`).  D = 1 launches P
    blocks, any P; D >= 2 is a cooperative launch of P * D blocks, which
    raises :class:`KernelError`, without launching, past the card's
    co-resident limit.  Returns the (D, C, T) it ran."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("psa_dp_traced kernel needs CUDA tensors, got %s"
                         % dev)
    P, n_pad = a.shape
    m_pad = b.shape[1]
    _check(a, "a", torch.uint8, (P, n_pad), dev)
    _check(b, "b", torch.uint8, (P, m_pad), dev)
    _check(lens, "lens", torch.int32, (P, 2), dev)
    _check(score, "score", torch.int32, (P,), dev)
    _check(corner, "corner", torch.int32, (P,), dev)
    _check(plane, "plane", torch.uint8, (P, m_pad, n_pad), dev)
    if n_pad % 4 or n_pad < 4 or m_pad < 1 or P < 1:
        raise ValueError("psa_dp_traced: %d pairs of n_pad %d (a multiple of "
                         "4) x m_pad %d" % (P, n_pad, m_pad))
    ran = _traced_launch("psa_dp_traced", a, b, lens, 0, params, None, None,
                         None, None, score, corner, plane, D, T)
    launches["psa_dp_traced"] += 1
    return ran


def psa_dp_chunk(a, b, lens, row_base, params, h_in, e_in, h_out, e_out,
                 best, corner, plane, *, D=None, T=None) -> tuple:
    """Launch the traced body at P = 1 over the rows [row_base, row_base +
    rows) of one pair: ``a``: (n_pad,) uint8, ``b``: (rows,) uint8 the
    chunk's rows, ``lens``: (2,) int32 real (n, m); ``h_in``/``e_in``:
    (n_pad,) int32 frontier of row row_base - 1; outputs ``h_out``/
    ``e_out`` (n_pad,) int32 (the chunk's last row), ``best``/``corner``
    (1,) int32 and ``plane`` (rows, n_pad) uint8, every cell's code.  D,
    C and T are the kernel's plan for n_pad on this card
    (:func:`psa_dp_chunk_layout`); ``D`` (C = n_pad / D rounded up to 4,
    which must give D shards) and ``T`` (1-256) override it, for tests
    and the smoke's T sweep.  Raises :class:`KernelError`, without
    launching, when the card cannot hold D blocks resident together.
    Returns the (D, C, T) it ran."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("psa_dp_chunk kernel needs CUDA tensors, got %s"
                         % dev)
    n_pad, rows = a.shape[0], b.shape[0]
    _check(a, "a", torch.uint8, (n_pad,), dev)
    _check(b, "b", torch.uint8, (rows,), dev)
    _check(lens, "lens", torch.int32, (2,), dev)
    for name, t in (("h_in", h_in), ("e_in", e_in), ("h_out", h_out),
                    ("e_out", e_out)):
        _check(t, name, torch.int32, (n_pad,), dev)
    _check(best, "best", torch.int32, (1,), dev)
    _check(corner, "corner", torch.int32, (1,), dev)
    _check(plane, "plane", torch.uint8, (rows, n_pad), dev)
    if n_pad % 4 or n_pad < 4 or rows < 1 or row_base < 0:
        raise ValueError("psa_dp_chunk: n_pad %d (a multiple of 4), rows "
                         "%d, row_base %d" % (n_pad, rows, row_base))
    ran = _traced_launch("psa_dp_chunk", a.view(1, n_pad), b.view(1, rows),
                         lens.view(1, 2), row_base, params, h_in, e_in, h_out,
                         e_out, best, corner, plane, D, T)
    launches["psa_dp_chunk"] += 1
    return ran


def psa_walk_bounded(plane, prev_row, base, i, j, t, forced, moves,
                     out, *, S=None) -> None:
    """Launch the PSA walk (one block on the window ring, S steps a
    phase: :func:`walk_s`) inside one row-chunk: ``plane``
    ((rows, n_pad) uint8) holds rows [base, base + rows) of the pair,
    ``prev_row`` ((n_pad,) uint8) the codes of row base - 1.  Walks from
    (i, j) with ``t`` moves made and ``forced`` carried until the walk
    leaves the chunk (or ends, at base 0), writing ``moves`` ((L,) int8)
    from index t on and ``out`` ((4,) int32) = (i, j, t, forced)."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError("psa_walk_bounded kernel needs CUDA tensors, got "
                         "%s" % dev)
    rows, n_pad = plane.shape
    L = moves.shape[0]
    _check(plane, "plane", torch.uint8, (rows, n_pad), dev)
    _check(prev_row, "prev_row", torch.uint8, (n_pad,), dev)
    _check(moves, "moves", torch.int8, (L,), dev)
    _check(out, "out", torch.int32, (4,), dev)
    inside = base <= i < base + rows or (base == 0 and i < 0)
    if not (inside and -1 <= j < n_pad and forced in (0, 1, 3) and t >= 0
            and t + max(i, -1) + j + 2 <= L):
        raise ValueError("psa_walk_bounded: entry (%d, %d, t %d, forced %d) "
                         "outside the chunk of rows [%d, %d) x %d columns, "
                         "or %d moves too few"
                         % (i, j, t, forced, base, base + rows, n_pad, L))
    S = walk_s(S)
    _check_copies(n_pad, "psa_walk_bounded", plane, prev_row)
    rc = _lib().tsta_psa_walk_bounded(
        plane.data_ptr(), prev_row.data_ptr(), rows, n_pad, base, i, j, t,
        forced, moves.data_ptr(), out.data_ptr(), S, _stream(dev))
    _raise_on(rc, "psa_walk_bounded")
    launches["psa_walk_bounded"] += 1


def poa_plan(n: int, D: int | None = None, T: int | None = None) -> tuple:
    """(D, C, S, T): how ``csrc/poa_dp.cu`` cuts an n-column launch (its
    ``tsta_poa_dp_layout``).  S columns per thread, a power of two (the
    kernel's strip lives in registers, one build per S): n over
    SHARD_MAX shards of SHARD_THREADS threads, at least SHARD_MIN_S, at
    most SHARD_MAX_S; C = SHARD_THREADS * S columns per shard; D = ceil(n
    / C) shards, the last one n - (D - 1) * C wide (past SHARD_MAX
    shards only at S = SHARD_MAX_S, where the card's blocks walk several
    each); T = SHARD_T nodes per packet, so the pipeline's fill is (D -
    1) * T nodes.  ``D`` forces the shard count (C = n / D rounded up to
    4, which must give D shards; S = C / SHARD_THREADS rounded up to a
    power of two, at least SHARD_MIN_S) and ``T`` the packet height: the
    kernel's overrides, for tests and sweeps."""
    def pow2(x):
        s = SHARD_MIN_S
        while s < x:
            s *= 2
        return s
    if D is None:
        S = min(SHARD_MAX_S, pow2(-(-n // (SHARD_MAX * SHARD_THREADS))))
        C = SHARD_THREADS * S
    else:
        C = (-(-n // max(D, 1)) + 3) // 4 * 4
        S = pow2(-(-C // SHARD_THREADS))
        if D < 1 or -(-n // C) != D or S > SHARD_MAX_S:
            raise ValueError("poa_plan: %d columns do not make %d shards of "
                             "a multiple of 4 and at most %d columns a "
                             "thread" % (n, D, SHARD_MAX_S))
    return -(-n // C), C, S, SHARD_T if T is None else T


def ring_width(n: int, D: int | None = None) -> int:
    """Ints per H or E row of an n-column launch's ring: D shards of
    SHARD_THREADS * S (:func:`poa_plan`, ``D`` as there)."""
    D, _, S, _ = poa_plan(n, D)
    return D * SHARD_THREADS * S


def poa_dp_layout(n: int) -> tuple:
    """(D, C, S, T): the shards, columns per shard, columns per thread and
    nodes per packet ``poa_dp.cu`` plans for an n-column launch, read from
    the built library (:func:`poa_plan` is its twin)."""
    out = [ctypes.c_int() for _ in range(4)]
    _lib().tsta_poa_dp_layout(n, *map(ctypes.byref, out))
    return tuple(v.value for v in out)


def poa_dp_max_blocks(T: int, S: int, dev, wide: bool = False) -> int:
    """The most ``poa_dp`` blocks of S columns a thread with T-node
    packets the card ``dev`` holds resident at once (0 without
    cooperative launch), of the 16-bit form or with ``wide`` the wide
    form, queried once per card, T, S and form."""
    with torch.cuda.device(dev):
        key = (torch.cuda.current_device(), T, S, bool(wide))
        if key not in _POA_LIMITS:
            limit = _lib().tsta_poa_dp_max_blocks(T, S, int(bool(wide)))
            if limit < 0:
                _raise_on(-limit, "poa_dp occupancy query")
            _POA_LIMITS[key] = limit
    return _POA_LIMITS[key]


def poa_dp(predsT, pmaskT, bases, fills, a, n_real, n_nodes, params, W,
           words, scores, *, ring=None, chunk_base=0, col0=0, ckpt=None,
           cw=None, lists=None, D=None, T=None, G=None) -> tuple:
    """Launch the POA round DP: D shards of C columns on G co-resident
    blocks (one cooperative launch for G >= 2), by default one shard a
    block up to the card's resident limit and past it several a block,
    walked in turn.  ``predsT``, ``pmaskT``: (max_in, N) int32 pred table
    (buffer row ids, 0 = the virtual row) and validity; ``bases``: (N,)
    int32; ``fills``: (4, N) int32 left-boundary seeds; ``a``: (n,)
    uint8, the read's columns [col0, col0 + n); ``W``: ring slots.
    Writes rows < ``n_nodes`` of ``scores`` ((N,) int32) and of
    ``words`` ((N, n) int16, or None for none).  A table wider than
    :data:`POA_MAX_IN` (up to :data:`POA_WIDE_MAX_IN`) runs the wide form:
    ``words`` int32 with 13-bit pred fields, each row's preds read from
    ``lists`` = (pcsr, poff), int32 (nnz, 2) and (N + 1,)
    (:func:`msa_poa.pred_lists`; poff may be a slice of a longer one, its
    offsets into pcsr), each use counted under its name with ``_wide``.

    Three uses, each with its launch counter: ``ring`` None is the single
    call (``poa_dp``, a private ring, words required); with ``ring``
    ((W, 2, ring_width(n, D)) int32, read and written in place) the rows
    are those of global rows ``chunk_base + i`` of a chunked round,
    either its forward chunk (``poa_dp_chunk``: no words, and ``ckpt``
    ((N, nwin, 3) int32) gets the H, q and F checkpoints at the last
    column of each of nwin windows of ``cw`` columns, by default n /
    nwin) or a window remat (``poa_dp_window``: words, no checkpoints),
    also counted there with checkpoints, a cell of the column-window
    wavefront (``parallel/msa_longseq.py``: words, and ``ckpt`` (N, 1,
    3) at global column ``cw`` - 1, its window's last).  D, C, S and T are
    :func:`poa_plan`'s; ``D`` and ``T`` (1-256) override it and ``G``
    (1..D) the grid, for tests and the smoke's sweeps.  Raises
    :class:`KernelError`, without launching, when the card cannot hold G
    blocks resident together.  Returns the (D, C, S, T, G) it ran."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("poa_dp kernel needs CUDA tensors, got %s" % dev)
    max_in, N = predsT.shape
    n = a.shape[0]
    _check(predsT, "predsT", torch.int32, (max_in, N), dev)
    _check(pmaskT, "pmaskT", torch.int32, (max_in, N), dev)
    _check(bases, "bases", torch.int32, (N,), dev)
    _check(fills, "fills", torch.int32, (4, N), dev)
    _check(a, "a", torch.uint8, (n,), dev)
    _check(scores, "scores", torch.int32, (N,), dev)
    wide = max_in > POA_MAX_IN
    if words is not None:
        _check(words, "words", torch.int32 if wide else torch.int16, (N, n),
               dev)
    if a.data_ptr() % 4:
        raise ValueError("poa_dp reads a four bytes at a time: a must be "
                         "4-byte aligned")
    if max_in > POA_WIDE_MAX_IN:
        raise ValueError("poa_dp packs pred indices into 13 bits: max_in %d "
                         "> %d" % (max_in, POA_WIDE_MAX_IN))
    if n % 4 or not 1 <= n_real or not 0 <= n_nodes <= N or W < 1 \
            or chunk_base < 0 or col0 < 0:
        raise ValueError("poa_dp: bad sizes n=%d n_real=%d n_nodes=%d N=%d "
                         "W=%d chunk_base=%d col0=%d"
                         % (n, n_real, n_nodes, N, W, chunk_base, col0))
    width = ring_width(n, D)   # the layout of the plan or of a forced D
    D, C, S, T = poa_plan(n, D, T)
    if not 1 <= T <= 256:
        raise ValueError("poa_dp: T %d outside 1..256" % T)
    if G is None:
        G = max(1, min(D, poa_dp_max_blocks(T, S, dev, wide)))
    elif not 1 <= G <= D:
        raise ValueError("poa_dp: G %d blocks outside 1..%d" % (G, D))
    nwin = 0
    if ring is None:
        if words is None or ckpt is not None or chunk_base or col0:
            raise ValueError("poa_dp: a single call takes words only")
        kind = "poa_dp"
        ring = torch.empty((W, 2, width), dtype=torch.int32, device=dev)
    else:
        _check(ring, "ring", torch.int32, (W, 2, width), dev)
        kind = "poa_dp_window" if words is not None else "poa_dp_chunk"
    if ckpt is not None:
        nwin = ckpt.shape[1]
        _check(ckpt, "ckpt", torch.int32, (N, nwin, 3), dev)
        if cw is None:
            if nwin < 1 or n % nwin:
                raise ValueError("poa_dp: %d columns in %d windows"
                                 % (n, nwin))
            cw = n // nwin
        elif nwin < 1 or cw < 1:
            raise ValueError("poa_dp: %d windows of %d columns" % (nwin, cw))
    else:
        cw = 0
    comm = flags = None
    if D > 1:
        nb = -(-n_nodes // T)
        comm = torch.empty((D, nb, 4 * T), dtype=torch.int32, device=dev)
        flags = torch.zeros((D, nb), dtype=torch.int32, device=dev)
    pcsr = poff = None
    if wide:
        kind += "_wide"
        if lists is None:
            raise ValueError("poa_dp: a table of %d preds takes the wide "
                             "form, which needs its pred lists" % max_in)
        pcsr, poff = lists
        _check(pcsr, "pcsr", torch.int32, (pcsr.shape[0], 2), dev)
        _check(poff, "poff", torch.int32, (N + 1,), dev)
    m_, x_, e_, o_ = params
    with torch.cuda.device(dev):
        rc = _lib().tsta_poa_dp(
            predsT.data_ptr(), pmaskT.data_ptr(), bases.data_ptr(),
            fills.data_ptr(), a.data_ptr(), N, n_nodes, n, n_real, W, max_in,
            m_, x_, e_, o_, chunk_base, col0, nwin, cw,
            None if words is None else words.data_ptr(), scores.data_ptr(),
            ring.data_ptr(), None if ckpt is None else ckpt.data_ptr(),
            D, C, S, T, G, None if comm is None else comm.data_ptr(),
            None if flags is None else flags.data_ptr(),
            None if pcsr is None else pcsr.data_ptr(),
            None if poff is None else poff.data_ptr(), _stream(dev))
    if rc == COOP_TOO_LARGE:
        raise KernelError(
            "%s: %d blocks of %d shards are not co-resident: %s holds at "
            "most %d at S = %d columns a thread, T = %d nodes (cooperative "
            "launch)" % (kind, G, D, torch.cuda.get_device_name(dev),
                         poa_dp_max_blocks(T, S, dev, wide), S, T))
    _raise_on(rc, kind)
    launches[kind] += 1
    return D, C, S, T, G


def poa_walk_bytes(S: int, R: int, max_in: int) -> int:
    """Dynamic shared memory of a POA walk block: two window buffers of R
    rows (at least one) of 2S + 8 words and R * max_in + 8 preds, or for
    a table wider than :data:`POA_MAX_IN` (the wide form) of 2S + 8 words
    of 4 bytes and the first :data:`POA_WIDE_HEAD` preds of each row
    (``poa_walk_stage.cuh``'s ``poa_walk_buf_bytes``)."""
    if max_in > POA_MAX_IN:
        return 2 * max(R, 1) * ((2 * S + 8) * 4 + POA_WIDE_HEAD * 4)
    return 2 * (max(R, 1) * (2 * S + 8) * 2 + (R * max_in + 8) * 4)


def poa_walk_plan(maxdist: int | None, max_in: int, *, S=None, R=None,
                  threads=None) -> tuple:
    """(S, R, threads): the POA walks' window ring for a round whose
    largest pred distance is ``maxdist`` rows (None: unknown) and whose
    pred table is ``max_in`` wide.  S moves a phase (:data:`POA_WALK_S`);
    R rows a window: 2S * maxdist covers every move of the next phase, so
    no move misses, capped at :data:`POA_WALK_ROWS_PER_S` * S (most moves
    go up one or two rows, so a larger window mostly stages rows no move
    reads) and at what two buffers leave of a block's shared memory;
    threads a block (:data:`POA_WALK_THREADS`).  ``S``, ``R`` and
    ``threads`` force their value (tests, sweeps; R = 0 makes every move
    read device memory).  Raises ValueError for S not a multiple of 8 of
    at least 8, a forced R that does not fit, or threads not a multiple of
    32 in [64, 256]."""
    S = POA_WALK_S if S is None else int(S)
    threads = POA_WALK_THREADS if threads is None else int(threads)
    if S < 8 or S % 8:
        raise ValueError("POA walk phase length S must be a multiple of 8, "
                         "got %d" % S)
    if threads % 32 or not WALK_MIN_THREADS <= threads <= WALK_MAX_THREADS:
        raise ValueError("POA walk: threads must be a multiple of 32 in "
                         "[%d, %d], got %d"
                         % (WALK_MIN_THREADS, WALK_MAX_THREADS, threads))
    row = poa_walk_bytes(S, 2, max_in) - poa_walk_bytes(S, 1, max_in)
    cap = (MAX_DYNAMIC_SMEM - poa_walk_bytes(S, 1, max_in)) // row + 1
    if R is None:
        R = min(POA_WALK_ROWS_PER_S * S, cap)
        if maxdist is not None:
            R = min(R, 2 * S * max(int(maxdist), 1))
    elif not 0 <= int(R) <= cap:
        raise ValueError("POA walk: R %d rows outside [0, %d] (two windows "
                         "of %d words a row and %d preds fit %d bytes)"
                         % (int(R), cap, 2 * S + 8,
                            POA_WIDE_HEAD if max_in > POA_MAX_IN else max_in,
                            MAX_DYNAMIC_SMEM))
    return S, int(R), threads


def _check_poa_copies(cols: int, words, preds, what: str) -> None:
    """The window ring stages in 16-byte copies: the plane's width a
    multiple of 8 words, the pred table a multiple of 4 ints, both
    16-byte aligned, else ValueError.  The 16-bit walk masks a pred index
    with the table's width, which must so be a power of two (as
    :func:`msa_poa.prepare` makes it); the wide form stages each row's
    head in one copy, so its rows are a multiple of 4 ints."""
    if cols % 8 or preds.numel() % 4 or words.data_ptr() % 16 \
            or preds.data_ptr() % 16:
        raise ValueError("%s stages the plane in 16-byte copies: %d columns "
                         "must be a multiple of 8, the pred table's %d ints "
                         "a multiple of 4, and both 16-byte aligned"
                         % (what, cols, preds.numel()))
    max_in = preds.shape[1]
    if (max_in % 4 if max_in > POA_MAX_IN else max_in & (max_in - 1)):
        raise ValueError("%s: a pred table %d wide; the 16-bit form takes a "
                         "power of two, the wide form a multiple of 4"
                         % (what, max_in))


def _poa_counts(counts, dev):
    if counts is None:
        return torch.empty((4,), dtype=torch.int32, device=dev)
    _check(counts, "counts", torch.int32, (4,), dev)
    return counts


def poa_walk(words, preds, best, n_real, align, *, maxdist=None, S=None,
             R=None, threads=None, counts=None):
    """Launch the POA walk (one block on the window ring,
    :func:`poa_walk_plan`'s S, R and threads for ``maxdist`` unless
    forced) over an (N, n) int16 word plane, or for ``preds`` wider than
    :data:`POA_MAX_IN` the wide form's int32 plane; ``preds``: (N,
    max_in) int32; ``best``: (1,) int32 start row; ``align``: (n,) int32
    output, pre-filled with -1 by the caller.  Returns ``counts`` ((4,)
    int32, allocated when None): moves, pred moves, misses, phases."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("poa_walk kernel needs CUDA tensors, got %s" % dev)
    N, n = words.shape
    max_in = preds.shape[1]
    wide = max_in > POA_MAX_IN
    _check(words, "words", torch.int32 if wide else torch.int16, (N, n), dev)
    _check(preds, "preds", torch.int32, (N, max_in), dev)
    _check(best, "best", torch.int32, (1,), dev)
    _check(align, "align", torch.int32, (n,), dev)
    if max_in > POA_WIDE_MAX_IN or not 1 <= n_real <= n:
        raise ValueError("poa_walk: max_in %d, n_real %d, n %d"
                         % (max_in, n_real, n))
    _check_poa_copies(n, words, preds, "poa_walk")
    S, R, threads = poa_walk_plan(maxdist, max_in, S=S, R=R,
                                  threads=threads)
    counts = _poa_counts(counts, dev)
    rc = _lib().tsta_poa_walk(words.data_ptr(), preds.data_ptr(),
                              best.data_ptr(), N, n, n_real, max_in,
                              align.data_ptr(), counts.data_ptr(), S, R,
                              threads, _stream(dev))
    kind = "poa_walk_wide" if wide else "poa_walk"
    _raise_on(rc, kind)
    launches[kind] += 1
    return counts


def poa_walk_bounded(words, preds, row, j, state, base, col0, align, out,
                     *, maxdist=None, S=None, R=None, threads=None,
                     counts=None):
    """Launch the POA walk (one block on the window ring, the plan as
    :func:`poa_walk`'s) inside one cell of a chunked round: ``words``
    ((nc, cw) int16) holds rows [base, base + nc) and columns [col0, col0
    + cw) of the round's plane, ``preds`` ((nc, max_in) int32) the cell's
    rows of the pred table.  Walks from (row, j, state) until it leaves
    the cell, writing ``align`` ((n,) int32) at the consumed columns, and
    ``out`` ((3,) int32) = (row, j, state).  Returns ``counts`` as
    :func:`poa_walk`; ``preds`` wider than :data:`POA_MAX_IN` take the
    wide form (``words`` int32)."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("poa_walk_bounded kernel needs CUDA tensors, got "
                         "%s" % dev)
    nc, cw = words.shape
    max_in = preds.shape[1]
    n = align.shape[0]
    wide = max_in > POA_MAX_IN
    _check(words, "words", torch.int32 if wide else torch.int16, (nc, cw),
           dev)
    _check(preds, "preds", torch.int32, (nc, max_in), dev)
    _check(align, "align", torch.int32, (n,), dev)
    _check(out, "out", torch.int32, (3,), dev)
    if max_in > POA_WIDE_MAX_IN or not 0 <= col0 <= n - cw or base < 0 \
            or state not in (0, 1, 2):
        raise ValueError("poa_walk_bounded: max_in %d, cell (%d, %d) of "
                         "(%d, %d), n %d, state %d"
                         % (max_in, base, col0, nc, cw, n, state))
    _check_poa_copies(cw, words, preds, "poa_walk_bounded")
    S, R, threads = poa_walk_plan(maxdist, max_in, S=S, R=R,
                                  threads=threads)
    counts = _poa_counts(counts, dev)
    rc = _lib().tsta_poa_walk_bounded(
        words.data_ptr(), preds.data_ptr(), nc, cw, max_in, row, j, state,
        base, col0, align.data_ptr(), out.data_ptr(), counts.data_ptr(), S,
        R, threads, _stream(dev))
    kind = "poa_walk_bounded_wide" if wide else "poa_walk_bounded"
    _raise_on(rc, kind)
    launches[kind] += 1
    return counts


def psa_ring_max_blocks(C: int, T: int, dev) -> int:
    """The most ``psa_ring`` blocks (shards of C columns, T-row packets)
    the card ``dev`` holds resident at once: the score-only body's
    (:func:`psa_dp_max_blocks`)."""
    return psa_dp_max_blocks(C, T, dev)


def psa_ring(a, b, D, T, n_real, m_real, params, comm, out) -> None:
    """Launch the ring wavefront: the score-only body at one pair over D
    shards of C = n / D columns, one co-resident block each, every padded
    cell run (D = 1 an ordinary launch, D >= 2 a cooperative one): ``a``:
    (n,) uint8, C a multiple of 128; ``b``: (m,) uint8, m a multiple of T;
    outputs ``comm`` ((D, m / T, 2T) int32, every edge packet) and ``out``
    ((D, 2) int32, each shard's best over the rows < m_real and its
    corner).  Raises :class:`KernelError`, without launching, when the
    card cannot hold D blocks resident together (the C side's check,
    :data:`COOP_TOO_LARGE`): a shard would wait on one never scheduled."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("psa_ring kernel needs CUDA tensors, got %s" % dev)
    n, m = a.numel(), b.numel()
    if D < 1 or T < 1 or n % (128 * D) or m < 1 or m % T:
        raise ValueError("psa_ring: n %d must be a multiple of 128 * D (D %d)"
                         " and m %d of T %d" % (n, D, m, T))
    C, mb = n // D, m // T
    _check(a, "a", torch.uint8, (n,), dev)
    _check(b, "b", torch.uint8, (m,), dev)
    _check(comm, "comm", torch.int32, (D, mb, 2 * T), dev)
    _check(out, "out", torch.int32, (D, 2), dev)
    if not (1 <= n_real <= n and 1 <= m_real <= m):
        raise ValueError("psa_ring: real lengths (%d, %d) outside (%d, %d)"
                         % (n_real, m_real, n, m))
    lens = torch.tensor([[n_real, m_real]], dtype=torch.int32, device=dev)
    _launch_shards("psa_ring", dev, 1, D, comm.view(1, D, mb, 2 * T),
                   out.view(1, D, 2),
                   *_score_entry(a.view(1, n), b.view(1, m), lens, params,
                                 True, D, C, T))
    launches["psa_ring"] += 1


def psa_ring_linked_max_blocks(C: int, T: int, dev) -> int:
    """The most blocks of the ring's linked build (shards of C columns,
    T-row packets) the card ``dev`` holds resident at once."""
    with torch.cuda.device(dev):
        limit = _lib().tsta_psa_dp_linked_max_blocks(C, T)
    if limit < 0:
        _raise_on(-limit, "psa_ring_linked occupancy query")
    return limit


class RingLink:
    """One card edge of the ring across cards (``ops/psa_ring.py``): the
    (mb, 2T) int32 packets that a card writes for the card to its right,
    one a row block in JAX's ``comm_ref`` layout, and (mb,) int32 flags,
    zero until that row block's packet is written, in host memory that has
    no name: a ``memfd_create`` object (shared memory, as a ``/dev/shm``
    file is, so ``cudaHostRegister`` maps it), made zeroed by
    ``RingLink(mb, T)`` and opened by another process of the node as
    ``RingLink(mb, T, path)`` from the maker's :attr:`path`
    (``/proc/<pid>/fd/<fd>``, valid while the maker keeps the link open).
    The memory goes with the last mapping, also when a process is killed.
    ``flags`` and ``pkts`` are CPU tensors on that memory.

    :meth:`attach` registers the mapping as mapped, portable pinned memory
    (``cudaHostRegister``) and returns its device pointers for a card,
    which the linked kernel writes and reads at system scope; a failure
    raises :class:`KernelError`.  The plain version (``psa_ring.
    ring_card_plain``) uses :meth:`put` and :meth:`get`, which blocks on
    the flag.  :meth:`close` undoes the registration and the mapping;
    call it once no kernel uses the link."""

    def __init__(self, mb: int, T: int, path: str | None = None):
        if mb < 1 or T < 1:
            raise ValueError("a link of %d row blocks of %d rows" % (mb, T))
        self.mb, self.T = mb, T
        fw = -(-mb // 64) * 64   # the packets from a 256-byte boundary
        self.nbytes = 4 * (fw + mb * 2 * T)
        self._fd = None
        if path is None:
            fd = os.memfd_create("tsta_ring_link")
            try:
                os.ftruncate(fd, self.nbytes)
                self._mm = mmap.mmap(fd, self.nbytes)
            except BaseException:
                os.close(fd)
                raise
            self._fd, self.path = fd, "/proc/%d/fd/%d" % (os.getpid(), fd)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                if os.fstat(fd).st_size != self.nbytes:
                    raise ValueError("link %s holds %d bytes, expected %d"
                                     % (path, os.fstat(fd).st_size,
                                        self.nbytes))
                self._mm = mmap.mmap(fd, self.nbytes)
            finally:
                os.close(fd)
            self.path = path
        self._words = np.frombuffer(self._mm, dtype=np.int32)
        self.flags = torch.from_numpy(self._words[:mb])
        self.pkts = torch.from_numpy(self._words[fw:]).view(mb, 2 * T)
        self._host = self._words.ctypes.data
        self._registered = False
        self._dev = {}   # card index -> (packets, flags) device pointers

    def attach(self, dev) -> tuple:
        """(packets, flags) device pointers of this link on card ``dev``,
        registering the mapping on first use."""
        dev = torch.device(dev)
        if dev.index not in self._dev:
            lib = _lib()
            with torch.cuda.device(dev):
                if not self._registered:
                    rc = lib.tsta_host_register(self._host, self.nbytes)
                    if rc:
                        raise KernelError(
                            "cudaHostRegister of a %d-byte ring link failed: "
                            "CUDA error %d" % (self.nbytes, rc))
                    self._registered = True
                ptr = ctypes.c_void_p()
                rc = lib.tsta_host_device_ptr(self._host, ctypes.byref(ptr))
                if rc or not ptr.value:
                    raise KernelError("cudaHostGetDevicePointer of a ring link"
                                      " on %s failed: CUDA error %d"
                                      % (dev, rc))
            off = self.pkts.data_ptr() - self._host
            self._dev[dev.index] = (ptr.value + off, ptr.value)
        return self._dev[dev.index]

    def put(self, rb: int, pkt: torch.Tensor) -> None:
        """Write row block ``rb``'s packet, then set its flag."""
        self.pkts[rb].copy_(pkt)
        self._words[rb] = 1

    def get(self, rb: int, timeout_s: float) -> torch.Tensor:
        """Row block ``rb``'s packet once its flag is set; TimeoutError
        past ``timeout_s`` seconds."""
        t0, pause = time.monotonic(), 2e-5
        while not self._words[rb]:
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(
                    "ring link %s: row block %d of %d not written within %g s"
                    % (self.path, rb, self.mb, timeout_s))
            time.sleep(pause)
            pause = min(2 * pause, 1e-3)
        return self.pkts[rb].clone()

    def close(self) -> None:
        if self._mm is None:
            return
        rc = _lib().tsta_host_unregister(self._host) if self._registered else 0
        self._registered = False
        self.flags = self.pkts = self._words = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        mm, self._mm = self._mm, None
        try:
            mm.close()
        except BufferError:   # a caller still holds a view: it goes with it
            pass
        _raise_on(rc, "cudaHostUnregister of a ring link")

    def __del__(self):
        if getattr(self, "_mm", None) is not None and not self._registered:
            self.close()


def psa_ring_linked(a, b, lens, params, D, T, col_base, shard_base, link_in,
                    link_out, comm, out) -> None:
    """Launch one card of the ring across cards: the score-only body's
    linked build at one pair over this card's columns, ``a`` ((n,) uint8:
    the pair's global columns [col_base, col_base + n)), against ``b``
    ((m,) uint8, m a multiple of T), ``lens`` ((1, 2) int32: the pair's
    real (n, m), global), every padded cell run, in D shards of C = ceil(n
    / D) columns on co-resident blocks (D = 1 an ordinary launch, D >= 2 a
    cooperative one); ``shard_base`` is the global index of its block 0
    (the watchdog's).  Block 0 reads its left packets from ``link_in`` (a
    :class:`RingLink`; None on the first card, whose left edge is the
    DP's boundary), the last block writes ``comm`` ((D, m / T, 2T) int32,
    every block's packets) and ``link_out`` (None on the last card);
    ``out`` ((D, 2) int32) gets each block's best over the rows < m_real
    and its corner.  Raises :class:`KernelError`, without launching, past
    the card's resident limit."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("psa_ring_linked kernel needs CUDA tensors, got %s"
                         % dev)
    n, m = a.numel(), b.numel()
    C = -(-n // max(D, 1))
    if D < 1 or T < 1 or -(-n // C) != D or m < 1 or m % T:
        raise ValueError("psa_ring_linked: %d columns in %d shards, m %d a "
                         "multiple of T %d" % (n, D, m, T))
    mb = m // T
    _check(a, "a", torch.uint8, (n,), dev)
    _check(b, "b", torch.uint8, (m,), dev)
    _check(lens, "lens", torch.int32, (1, 2), dev)
    _check(comm, "comm", torch.int32, (D, mb, 2 * T), dev)
    _check(out, "out", torch.int32, (D, 2), dev)
    for lk in (link_in, link_out):
        if lk is not None and (lk.mb, lk.T) != (mb, T):
            raise ValueError("a link of (%d, %d), the launch's (%d, %d)"
                             % (lk.mb, lk.T, mb, T))
    pin, fin = link_in.attach(dev) if link_in is not None else (None, None)
    pout, fout = (link_out.attach(dev) if link_out is not None
                  else (None, None))
    lib = _lib()
    m_, x_, e_, o_ = params

    def call(comm_p, flags_p, out_p, scratch_p, stream):
        return lib.tsta_psa_dp_linked(
            a.data_ptr(), b.data_ptr(), lens.data_ptr(), n, m, m_, x_, e_,
            o_, D, C, T, comm_p, flags_p, out_p, scratch_p, col_base,
            shard_base, pin, fin, pout, fout, stream)

    _launch_shards("psa_ring_linked", dev, 1, D, comm.view(1, D, mb, 2 * T),
                   out.view(1, D, 2), lib.tsta_psa_dp_scratch_words(C, T),
                   call, lambda: psa_ring_linked_max_blocks(C, T, dev),
                   "C = %d columns, T = %d rows" % (C, T))
    launches["psa_ring_linked"] += 1


def walk_probe_out_cols(probe: str, n: int) -> int:
    """The width of a walk probe's ``out`` at N = ``n``, as its script's."""
    return {"a": n + 1, "b": PROBE_B_OUT_COLS, "c": n + 8, "e": 1}[probe]


def _walk_probe_args(probe: str, plane, out, mode: str, n: int):
    """Check a walk probe's tensors and return (device, mode index)."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError("walk_probe_%s needs CUDA tensors, got %s"
                         % (probe, dev))
    modes = WALK_PROBE_MODES[probe]
    if mode not in modes:
        raise ValueError("walk_probe_%s: mode %r not in %s"
                         % (probe, mode, modes))
    if plane.dim() != (3 if probe == "e" else 2):
        raise ValueError("walk_probe_%s: plane of shape %s"
                         % (probe, tuple(plane.shape)))
    _check(plane, "plane", torch.int32, plane.shape, dev)
    if n < 1 or (probe == "b" and n % 8):
        raise ValueError("walk_probe_%s: N %d (a multiple of 8 in b)"
                         % (probe, n))
    if probe in "ab" and (plane.shape[1] != PROBE_AB_BAND[1]
                          or plane.shape[0] < PROBE_AB_BAND[0]):
        raise ValueError("walk_probe_%s: the plane must be (>= 24, 1024), "
                         "got %s" % (probe, tuple(plane.shape)))
    if probe == "c" and (plane.shape[0] < PROBE_C_BAND[0]
                         or plane.shape[1] < PROBE_C_BAND[1]
                         or plane.shape[1] % 4 or plane.data_ptr() % 16):
        raise ValueError("walk_probe_c: the plane must be (>= 128, >= 256) "
                         "with rows of 16-byte multiples, got %s"
                         % (tuple(plane.shape),))
    cols = walk_probe_out_cols(probe, n)
    if out.dim() != 2 or out.shape[1] != cols or out.shape[0] < 1:
        raise ValueError("walk_probe_%s: out of shape %s, expected (P, %d)"
                         % (probe, tuple(out.shape), cols))
    _check(out, "out", torch.int32, out.shape, dev)
    if probe == "e" and (tuple(plane.shape) != PROBE_E_X
                         or out.shape[0] != 1):
        raise ValueError("walk_probe_e: x %s and out %s, expected %s and "
                         "(1, 1)" % (tuple(plane.shape), tuple(out.shape),
                                     PROBE_E_X))
    return dev, modes.index(mode)


def walk_probe_a(plane, out, mode: str, n: int) -> None:
    """Launch Q2-17a (``walk_probes.cu``, scripts/walk_ablate.py's kernel)
    in ``mode`` at N = ``n`` steps, one block a row of ``out`` ((P, n + 1)
    int32, INT32_MIN where no mode writes: the caller fills it); ``plane``:
    (>= 24, 1,024) int32."""
    dev, k = _walk_probe_args("a", plane, out, mode, n)
    rc = _lib().tsta_walk_probe_a(plane.data_ptr(), out.data_ptr(), k, n,
                                  out.shape[0], plane.shape[0], PROBE_BI0,
                                  _stream(dev))
    _raise_on(rc, "walk_probe_a")
    launches["walk_probe_a"] += 1


def walk_probe_b(plane, out, mode: str, n: int) -> None:
    """Launch Q2-17b (scripts/walk_ablate2.py's kernel) as
    :func:`walk_probe_a`, ``out`` (P, 10,248), ``n`` a multiple of 8."""
    dev, k = _walk_probe_args("b", plane, out, mode, n)
    rc = _lib().tsta_walk_probe_b(plane.data_ptr(), out.data_ptr(), k, n,
                                  out.shape[0], plane.shape[0], PROBE_BI0,
                                  _stream(dev))
    _raise_on(rc, "walk_probe_b")
    launches["walk_probe_b"] += 1


def walk_probe_c(plane, out, mode: str, n: int) -> None:
    """Launch Q2-17c (scripts/walk_ablate3.py's kernel) as
    :func:`walk_probe_a` on an (M_ROWS, N_W) int32 ``plane``, ``out`` (P,
    n + 8)."""
    dev, k = _walk_probe_args("c", plane, out, mode, n)
    rc = _lib().tsta_walk_probe_c(plane.data_ptr(), out.data_ptr(), k, n,
                                  out.shape[0], plane.shape[0],
                                  plane.shape[1], _stream(dev))
    _raise_on(rc, "walk_probe_c")
    launches["walk_probe_c"] += 1


def walk_probe_e(x, out, steps: int = 64) -> None:
    """Launch Q2-17e (scripts/db_probe.py's kern): ``x`` (16, 8, 128)
    int32 into the two buffers of the band, then ``steps`` reads summed
    into ``out`` ((1, 1) int32)."""
    dev, _ = _walk_probe_args("e", x, out, "db", max(steps, 1))
    rc = _lib().tsta_walk_probe_e(x.data_ptr(), out.data_ptr(), steps,
                                  _stream(dev))
    _raise_on(rc, "walk_probe_e")
    launches["walk_probe_e"] += 1
