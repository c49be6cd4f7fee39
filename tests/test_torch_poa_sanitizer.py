"""ASan/UBSan run of the port's POA graph helpers (``poa_fast.c``).

The native MSA engine calls ``tsta_poa_hm1`` (the DP's left boundary),
``tsta_poa_merge`` (the read's merge into the graph) and
``tsta_poa_toposort`` every round.  As ``test_native_sanitizer.py`` does
for the compat engine, ``tsta_tpu_torch/native/poa_fast.c`` links here
into a standalone driver built with ``-fsanitize=address,undefined``.
The test grows a multi-pred graph through the port's rounds, records the
exact arguments the engine passes to the three helpers at its last round
(buffers cut to the sizes the engine allocates), runs the driver on
them, and requires the sanitized results to equal the engine's own
ctypes calls.  It skips where the compiler lacks the sanitizer runtimes.
"""

import copy
import os
import subprocess

import numpy as np
import pytest
import torch

from tsta_tpu_torch.config import AlignParams
from tsta_tpu_torch.device import CPU_BUDGET
from tsta_tpu_torch.models.poa_graph import PoaGraph
from tsta_tpu_torch.native import build
from tsta_tpu_torch.ops import msa_native, msa_poa

SRC = os.path.join(os.path.dirname(build.__file__), "poa_fast.c")

DRIVER = r"""
#include <stdio.h>
#include <stdlib.h>

long tsta_poa_toposort(long n, const long *sptr, const long *sidx,
                       const long *indeg_in, const long *vptr,
                       const long *vidx, long *order);
void tsta_poa_hm1(long n_real, long max_in, const int *preds,
                  const long *lens, long e, long o, long *hm1);
long tsta_poa_merge(long n, long cap, long pmax, long vmax,
                    unsigned char *bases, int *ndeg, int *preds,
                    int *weights, unsigned char *passing, long n_seq,
                    long seq_no, int *nvar, int *vars,
                    const unsigned char *seq, long slen, const long *align);

static FILE *in;

static long rd(void) {
  long v;
  if (fscanf(in, "%ld", &v) != 1) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  return v;
}
/* exact-size buffers, so an access past the engine's sizes is caught */
static long *rdl(long n) {
  long *a = malloc((size_t)(n > 0 ? n : 1) * sizeof(long));
  for (long i = 0; i < n; i++) a[i] = rd();
  return a;
}
static int *rdi(long n) {
  int *a = malloc((size_t)(n > 0 ? n : 1) * sizeof(int));
  for (long i = 0; i < n; i++) a[i] = (int)rd();
  return a;
}
static unsigned char *rdb(long n) {
  unsigned char *a = malloc((size_t)(n > 0 ? n : 1));
  for (long i = 0; i < n; i++) a[i] = (unsigned char)rd();
  return a;
}
static void pl(const char *tag, const long *a, long n) {
  printf("%s", tag);
  for (long i = 0; i < n; i++) printf(" %ld", a[i]);
  printf("\n");
}
static void pi(const char *tag, const int *a, long n) {
  printf("%s", tag);
  for (long i = 0; i < n; i++) printf(" %d", a[i]);
  printf("\n");
}
static void pb(const char *tag, const unsigned char *a, long n) {
  printf("%s", tag);
  for (long i = 0; i < n; i++) printf(" %d", a[i]);
  printf("\n");
}

int main(int argc, char **argv) {
  if (argc != 2 || !(in = fopen(argv[1], "r"))) return 2;
  /* tsta_poa_hm1 */
  long n_real = rd(), max_in = rd(), e = rd(), o = rd(), nh = rd();
  int *hp = rdi(n_real * max_in);
  long *lens = rdl(n_real), *hm1 = rdl(nh);
  tsta_poa_hm1(n_real, max_in, hp, lens, e, o, hm1);
  pl("hm1", hm1, nh);
  /* tsta_poa_merge */
  long n = rd(), cap = rd(), pmax = rd(), vmax = rd(), n_seq = rd(),
       seq_no = rd(), slen = rd();
  unsigned char *bases = rdb(cap);
  int *ndeg = rdi(cap), *preds = rdi(cap * pmax), *weights = rdi(cap * pmax);
  unsigned char *passing = rdb(cap * n_seq);
  int *nvar = rdi(cap), *vars = rdi(cap * vmax);
  unsigned char *seq = rdb(slen);
  long *align = rdl(slen);
  long added = tsta_poa_merge(n, cap, pmax, vmax, bases, ndeg, preds,
                              weights, passing, n_seq, seq_no, nvar, vars,
                              seq, slen, align);
  printf("added %ld\n", added);
  pb("bases", bases, cap);
  pi("ndeg", ndeg, cap);
  pi("preds", preds, cap * pmax);
  pi("weights", weights, cap * pmax);
  pb("passing", passing, cap * n_seq);
  pi("nvar", nvar, cap);
  pi("vars", vars, cap * vmax);
  /* tsta_poa_toposort */
  long tn = rd();
  long *sptr = rdl(tn + 1);
  long *sidx = rdl(sptr[tn]);
  long *indeg = rdl(tn);
  long *vptr = rdl(tn + 1);
  long *vidx = rdl(vptr[tn]);
  long *order = calloc((size_t)(tn > 0 ? tn : 1), sizeof(long));
  long placed = tsta_poa_toposort(tn, sptr, sidx, indeg, vptr, vidx, order);
  printf("placed %ld\n", placed);
  pl("order", order, tn);
  free(hp); free(lens); free(hm1); free(bases); free(ndeg); free(preds);
  free(weights); free(passing); free(nvar); free(vars); free(seq);
  free(align); free(sptr); free(sidx); free(indeg); free(vptr); free(vidx);
  free(order);
  fclose(in);
  return 0;
}
"""


@pytest.fixture(scope="module")
def poa_asan_bin(tmp_path_factory):
    d = tmp_path_factory.mktemp("poa_asan")
    drv = d / "poa_asan_driver.c"
    drv.write_text(DRIVER)
    out = str(d / "poa_asan_driver")
    cmd = [build.compiler(), "-O1", "-g", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=all", "-fno-omit-frame-pointer", "-Wall",
           SRC, str(drv), "-o", out]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip("sanitizer toolchain unavailable: %s"
                    % proc.stderr[:200])
    return out


def _reads(seed, n_reads, length, div=0.12):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    reads = [base.tobytes()]
    for _ in range(n_reads - 1):
        s = base.copy()
        hit = rng.integers(0, length, int(length * div))
        s[hit] = rng.choice(acgt, hit.size)
        s = np.delete(s, rng.integers(0, length, int(length * div / 8)))
        reads.append(np.insert(s, rng.integers(0, len(s), length // 40),
                               acgt[rng.integers(0, 4, length // 40)])
                     .tobytes())
    return reads


def _buffers(g):
    return [g._bases, g._ndeg, g._preds, g._weights, g._passing, g._nvar,
            g._vars]


def _toposort_inputs(g):
    """The arguments ``PoaGraph._toposort_native`` builds."""
    n = len(g)
    nd, _, _, _, sptr, sidx = g.csr()
    vn = g._nvar[:n].astype(np.int64)
    vmask = np.arange(g._vars.shape[1]) < vn[:, None]
    vidx = g._vars[:n][vmask].astype(np.int64)
    vptr = np.zeros(n + 1, np.int64)
    np.cumsum(vn, out=vptr[1:])
    return n, sptr, sidx, nd, vptr, vidx


@pytest.mark.parametrize("seed,length", [(3, 300), (4, 900)])
def test_poa_helpers_asan_clean(poa_asan_bin, tmp_path, monkeypatch, seed,
                                length):
    params = AlignParams()
    cpu = torch.device("cpu")
    reads = _reads(seed, 5, length)
    g = PoaGraph.from_sequence(reads[0], len(reads))
    for sno in range(1, len(reads) - 1):
        packed, order, _ = msa_poa.run_round(g, reads[sno], params, cpu,
                                             "auto", CPU_BUDGET)
        msa_native._finish_round(g, reads[sno], sno, order, packed.numpy(),
                                 [], [], [])
    assert g.max_in_degree() >= 2
    calls = {}
    real_hm1, real_merge = msa_poa._hm1, msa_native._merge_native

    def spy_hm1(N_real, max_in, preds, lens, e_, o_, hm1):
        calls["hm1_in"] = (N_real, max_in, preds[:N_real].copy(),
                           np.asarray(lens, np.int64).copy(), e_, o_,
                           hm1.copy())
        real_hm1(N_real, max_in, preds, lens, e_, o_, hm1)
        calls["hm1_out"] = hm1.copy()

    def spy_merge(g, seq_arr, seq_no, align):
        calls["merge_in"] = (len(g), copy.deepcopy(_buffers(g)), g.n_seq,
                             seq_no, seq_arr.copy(),
                             np.asarray(align, np.int64).copy())
        added = real_merge(g, seq_arr, seq_no, align)
        calls["merge_out"] = (added, copy.deepcopy(_buffers(g)))
        return added

    monkeypatch.setattr(msa_poa, "_hm1", spy_hm1)
    monkeypatch.setattr(msa_native, "_merge_native", spy_merge)
    sno = len(reads) - 1
    packed, order, _ = msa_poa.run_round(g, reads[sno], params, cpu, "auto",
                                         CPU_BUDGET)
    msa_native._finish_round(g, reads[sno], sno, order, packed.numpy(), [],
                             [], [])
    monkeypatch.setenv("TSTA_NATIVE_TOPO", "force")
    want_order = g.toposort()
    topo = _toposort_inputs(g)

    N_real, max_in, hp, lens, e_, o_, hm1 = calls["hm1_in"]
    n, bufs, n_seq, seq_no, seq, align = calls["merge_in"]
    cap, pmax, vmax = bufs[0].shape[0], bufs[2].shape[1], bufs[6].shape[1]
    parts = [[N_real, max_in, e_, o_, hm1.size], hp, lens, hm1,
             [n, cap, pmax, vmax, n_seq, seq_no, seq.size], *bufs, seq, align,
             [topo[0]], *topo[1:]]
    text = "\n".join(" ".join(map(str, np.asarray(p).astype(np.int64).ravel()))
                     for p in parts)
    f = tmp_path / "calls.txt"
    f.write_text(text + "\n")
    env = dict(os.environ,
               ASAN_OPTIONS="detect_leaks=1:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1")
    proc = subprocess.run([poa_asan_bin, str(f)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, (
        "sanitizer run failed (rc=%d)\nstderr:\n%s"
        % (proc.returncode, proc.stderr[-4000:]))
    got = {ln.split(" ", 1)[0]: ln.split()[1:]
           for ln in proc.stdout.splitlines()}

    def arr(tag):
        return np.asarray(got[tag], np.int64)

    assert np.array_equal(arr("hm1"), calls["hm1_out"])
    added, after = calls["merge_out"]
    assert int(got["added"][0]) == added > 0
    for tag, want in zip(("bases", "ndeg", "preds", "weights", "passing",
                          "nvar", "vars"), after):
        assert np.array_equal(arr(tag), want.astype(np.int64).ravel()), tag
    assert int(got["placed"][0]) == topo[0] == len(want_order)
    assert arr("order").tolist() == want_order
