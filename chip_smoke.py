#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (tsta_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device: card name, ``nvidia-smi`` name and power limit, torch, CUDA
   and nvcc versions;
2. build: the kernels of ``tsta_tpu_torch/csrc`` compiled with nvcc for
   sm_90a into the ignored ``build/`` directory, and each PSA walk's step
   loops in the library's SASS (``walk_probes.walk_sass_steps``: their
   instructions a step, a pair-step in the two-pair walk);
3. kernels: each kernel against its plain PyTorch version on the card,
   exact integer equality (the score-only DP, K1, ``psa_dp.cu``, on a
   mixed 100-3,000 bp batch and a 40 kbp pair at its plan's shards; the
   traced DP, ``psa_dp_traced.cu``, on 4
   pairs of 2-4 kbp, every cell code; the walk on that plane, moves and
   counts);
4. main path: ``tsta-torch psa`` on the reference's 10,000 x 10,000 bp
   example pair (recovered from ``tests/golden/example_big``), traced and
   score-only, with the launch counters reset before each and read after;
   the output must be byte-identical to the golden and stdout
   ``maxsorce=-5``, and ``--notrace`` one K1 launch over its plan's
   shards at one pair (``psa_diff.score_plan``, D >= 2, equal to the
   kernel's layout) and no plain call; then ``python -m tsta_tpu_torch
   psa -X -3`` against ``psa_x3.out``;
5. batches: 128 x 10,240 bp score-only and 32 x 10 kbp traced (slot 0 the
   example pair), exact against the plain versions and the golden;
6. timings: kernel and plain version on the card at the main path's
   shapes (CUDA events), and every output of those runs (scores, corners,
   each plane byte, walk words and counts) exactly equal; the kernels
   record's errors are these (K1 also at one pair, the example); then
   ``psa_traced_plan``: the traced DP's plan at 32 x 10 kbp and 1 x 10
   kbp (``psa_diff.traced_plan``, equal to the kernel's layout) and its
   sweep, the group at the D of each plan with the least W 4 or 8 and 1
   or 2 blocks an SM, every output equal to the plan's run; and
   ``psa_score_plan``: the score-only DP's plan at 1 (the example), 32
   and 128 x 10,240 bp (``psa_diff.score_plan``, equal to the kernel's
   layout) and its sweep, the least W 2, 4 or 8 and 1 or 2 blocks an SM,
   and at one pair T = 16, 32 and 64, every output equal to the plan's
   run; the walks' records carry their plan (Q2-8 its phase length S,
   ``_kernels.WALK_S``; K3 its S and threads a block,
   ``_kernels.psa_walk_layout``) and their chain bound, and K3 at 32 x 10
   kbp its S sweep (32, 64, 128), every word and count equal to the plain
   walk; (b) K3 on a traced batch of more pairs than SMs:
   ``align_batch_traced_device`` on phase 16 (c)'s 4,096 pairs of
   150-2,000 bp, one traced DP and one K3 launch a group, no plain call,
   every score and corner equal to K1's, the largest groups at a smaller
   S than one pair's; each group's walk timed (CUDA events) and equal to
   the plain walk in every word and count;
7. POA kernels: the round DP and the walk against their plain versions
   on the card on seeded grown graphs (multi-pred nodes) and on a graph
   whose last read takes an edge that skips ~300 rows (``deletion_reads``;
   its walk must miss its window), every real word, score and aligned row
   equal; the walk also at forced plans (S, R, threads), R = 0 among them
   (every move reads device memory), its counters (moves, pred moves,
   misses, phases) equal to ``msa_poa.poa_walk_staged_plain``'s replay of
   each plan; the DP also at forced D = 2, 3 and
   5 shards (T = 16, 1, 32), which its plan gives one shard at these
   2,048 columns, and at 5 shards on 2 blocks and 3 on 1, each block
   walking its shards in turn; then a round of a 1.1 Mbp read (1,105,920
   columns, 135 shards, more than the card's co-resident blocks) against
   a small grown graph, single call and forward chunk (words, scores,
   ring, checkpoints) equal to the plain version;
8. MSA main path: ``tsta-torch msa --engine native`` on the reference's
   5 x 5,000 bp example (recovered from ``tests/golden/example_big``),
   launch counters reset before and read after: one DP and one walk per
   round, no plain round; round scores, graph and add lengths and the
   output file's sha256 as the JAX native engine gives them; then
   ``tsta-torch msa`` with the compat engine, byte-identical to the
   reference's ``msa_default.out``;
9. 3 x 50 kbp (``bench.stage_msa_50k``'s reads, seed 7) with the kernels
   and with the plain versions on the card, equal in every output: walls,
   cells/s, peak device memory and each round's split;
10. the fleet: 6 problems of 5 x 5 kbp (seeds 100-105, as
    ``bench.stage_msa_fleet``) through ``align_seqs_many``, equal to
    per-problem runs: problems/s of the process's first call and of a
    second one;
11. POA timings: each POA kernel and its plain version at the 3 x 50 kbp
    round-2 shape and the example's last round (CUDA events), every
    output of the timed runs equal; the kernels record's errors are these,
    with the DP's plan (D shards of C columns, S a thread, T nodes a
    packet: ``msa_poa.poa_plan``) and the walk's (S moves a phase, R rows
    a window, threads: ``msa_poa.poa_walk_plan``), its counters and its
    chain bound from them; then the plan's S x T sweep at the 50
    kbp round 2 (S = 8, 16, 32; T = 16, 32, 64), every output equal to the
    plan's run;
12. chunked kernels against their plain versions, with times (CUDA
    events): a forward chunk of the 3 x 50 kbp round 2 cut into 8,192-row
    chunks (scores, ring out, checkpoints); after phase 14, rounds 1 and 2
    of the 200 kbp reads forward again (round 2 on the graph round 1
    through the kernels gives), each round's last chunk from its entry
    ring (scores, ring out, checkpoints) and the first cell its walk
    rematerialises (words, ring out) and walks (exit state, align
    entries), and round 1's forward chunk over the plan's S x T sweep,
    every output equal to the plan's run;
13. 3 x 50 kbp with a budget that cuts every round into >= 4 chunks,
    equal to phase 9's unchunked run, through the chunk, window and
    bounded-walk kernels and no plain round;
14. the slice at full width: 3 x 200 kbp (``bench.stage_msa_200k``'s
    reads, seed 13) through ``msa_native.align_seqs`` at the card's own
    budget, every round chunked: wall, cells/s, each round's forward and
    backward split, remats, cells walked and plan, peak device memory,
    launches and round scores; every MSA row without its gaps equal to
    its read; after the timed run, round 1's score equal to the PSA DP's
    score of reads 1 and 0 (a global pairwise alignment: the graph is
    read 0's chain) and to the score of MSA rows 0 and 1, and round 2's
    equal to phase 12's forward of it and at least read 2's pairwise
    score with read 0 and with read 1;
15. the chunked traced PSA: (a) the 10 kbp example through 20 chunks of 512
    rows, byte-identical to the golden and equal to the unchunked path;
    (b) a 200,000-column pair (read 0 of the 200 kbp set against a ~2 kbp
    mutated stretch of it) at 512 rows per chunk, each chunk's DP from its
    snapshot (codes, frontier out, best, corner) and each chunk's walk
    (moves, exit state) held to the plain versions, and the alignment
    re-scoring to K1's corner; (c) ``tsta-torch psa`` on reads 0 and 1 at
    the card's own budget (3 chunks of 65,536 rows), the launch counters
    reset before and read after: only the chunk DP and bounded walk,
    ``maxsorce`` and the corner equal to K1's (phase 14) and to round 1's
    score, the rows re-scoring to it and equal to the reads without their
    gaps: wall, GCUPS, forward and backward split, remats, each launch's
    ms and peak device memory, and the walk's S; (d) after it, (c)'s chunk
    0 at (c)'s shape (65,536 rows x the full width), its DP from the entry
    frontier and its walk from the state (c)'s walk entered it with, held
    to the plain versions in every output, which give the kernels record's
    plain ms, and that walk's S sweep (32, 64, 128), every output equal;
    the chunk DP's plan (D shards of C columns, W per thread, T rows per
    packet: ``psa_chunked.chunk_plan``, equal to the kernel's), its
    median over PR 10's 108.78 ms, and the T sweep, the same chunk at T =
    16 to 256, every output equal; (e) ``tsta-torch psa --notrace --json``
    on (c)'s reads, the counters and plain calls reset before and read
    after: one K1 launch over its plan's shards and nothing else, wall,
    maxsorce and corner equal to (c)'s and to the plain version's on the
    card;
16. edit scoring (M = 0, X = -1, E = -1, O = 0) on the round-1 kernels,
    the launch counters and the count of plain calls on the card reset
    before each path and read after it: (a) ``tsta-torch psa`` on the 10
    kbp example, traced and ``--notrace``, equal in bytes to ``--kernel
    plain`` on the card, the rows re-scoring to the corner, through the
    traced DP (Q2-13), the walk (Q2-16, its S printed) and, ``--notrace``,
    K1, then the DP and the walk against their plain versions at that
    shape (every plane byte, the moves), with the DP's plan and sweep as in
    phase 6;
    (b)
    ``psa_pallas.psa_align_batch`` on phase 5's 128 x 10,240 bp pairs
    (Q2-14, K1) against the plain version; (c) 4,096 seeded pairs of
    150-2,000 bp with ~10% edits through it (Q2-15, the short-pair kernel,
    one launch) against the plain version and K1, with K1's time on the
    same batch, the bound, the end-to-end GCUPS of the route's first call
    and of three later ones (equal outputs) and the kernel's plan (its
    strip widths with their pair counts, launches, blocks, warps an SM);
    (d)
    ``tsta-torch psa`` on reads 0 and 1 of the 200 kbp set at the card's
    budget, in 3 chunks, its maxsorce and corner equal to a K1 pass over
    the pair and its rows re-scoring to the corner: wall, forward and
    backward split, peak device memory;
17. the difference method (``psa_dp_diff.cu``: int16 offsets on K1's
    schedule of P x D co-resident column shards), the launch counters and
    the count of plain calls on the card reset before each path: (a)
    phase 3's mixed batch and 40 kbp pair through it, every score and
    corner equal to the plain version's and K1's, at the plan and at
    forced D = 1, 2 and 8 (``layout_forced``); (b) the gate's edge, D =
    57: 8 identical 10,240 bp pairs under (57, -1, -1, 0) and phase 3's
    batch under (2, -57, -2, -4), the same, and the kernel's plan (D, C,
    W, G, T, read from the library) equal to ``psa_diff.diff_plan`` at
    over 4,000 (pairs, width, SMs); (c) ``bench.stage_int16_probe``'s
    shape, 32 x 10,240 bp with slot 0 the example, through
    ``psa_align_batch_diff`` int32 and int16 in turns (5 calls each after
    a warm-up, medians): ``psa_batch_int32_gcups``,
    ``psa_batch_int16_gcups``, ``int16_speedup``,
    ``psa_batch_int16_exact``; then the kernel, K1 and the plain version
    at phase 5's 128 x 10,240 bp (CUDA events), every output equal, the
    kernel also at forced D = 1, 2 and 8 (one past the resident limit
    must raise the kernel's own ``KernelError``), its plan and its sweep
    there and at 32 x 10,240 (K1's shards at its least W 2, 4 or 8 and 1
    or 2 blocks an SM, every output equal); (d) ``TSTA_DIFF_INT16=1
    tsta-torch psa --notrace`` on the example, ``--json`` in a subprocess
    and plain in this process: ``maxsorce=-5`` through one int16 launch
    and nothing else; (e) the dtype-max probe (``dtype_max_probe.cu``, Q2-17d), every
    form (int32, int16, uint16, int8, uint8 maxes, the s32 and s16x2 DPX
    forms) equal to numpy, with its rates;
18. the striped layout (``psa_dp_striped.cu``: K1's schedule on JAX's
    striped tile, which it reads itself) and the two-pair walk
    (``psa_walk_pair2.cu``), the launch counters and the count of plain
    calls on the card reset before each path: (a) phase 3's mixed batch
    through ``psa_align_batch_diff(layout="striped")``, every score and
    corner equal to K1's and the plain version's, and the 40 kbp pair,
    equal to K1's, each also at forced D = 1, 2 and 8; (b) the kernel, K1
    and the plain version at phase 5's 128 x 10,240 bp (CUDA events),
    every output equal, forced D = 1, 2 and 8 and K1's plan sweep (the
    least W 2, 4 or 8, 1 or 2 blocks an SM) on the tile; (c)
    ``TSTA_PSA_LAYOUT=striped tsta-torch batch --pairs ... --scores ...``
    on those pairs in a subprocess: the scores TSV equal to the default
    run's (in this process, through K1), the striped kernel launched and
    K1 not; (d) phase 5's 32 x 10 kbp traced plane walked by K3 and the
    two-pair walk (CUDA events), every word and count equal to phase 6's
    plain walk of that plane, then its first 31 pairs, which take K3; then
    phase 6 (b)'s traced batch of 4,096 short pairs, group by group, both
    walks timed (sums over the groups, and over the groups of an even
    number of pairs, those the two-pair walk takes) and held to phase 6
    (b)'s plain walks, an odd group taking K3;
19. the ring wavefront (``psa_dp.cu`` at one pair, every padded cell:
    one long pair's columns sharded over co-resident blocks, one per
    ``seq`` shard of a virtual one-card mesh): (a) the kernel against its
    plain version (best, corner, every
    edge packet) on the 10 kbp example at D = 8, T = 256 and D = the SM
    count, T = 32, and at (b)'s own D, T and C = 1,536 columns per shard:
    the 200 kbp pair's ``a`` against its ``b`` cut to two row blocks (the
    kernels record's times); (b) ``align_long_ring`` on phase
    14's 200 kbp pair (K1's a and b) at D = the SM count, T = 256, the
    launch counters and the plain calls on the card reset before and read
    after, best and corner equal to phase 14's K1 (the same body) and to
    phase 15 (c)'s traced route (another body), then the median of 3
    launches (CUDA events), GCUPS, bound, peak device memory; (c) the
    same under edit scoring, equal to phase 16's K1 pass and (d)'s traced
    route; (d) D = 16 and
    66 at full width, equal to K1; (e) one shard past the card's resident
    limit raises ``KernelError`` without launching;
20. a traced mid-length pair: reads 0 and 1 of the 200 kbp set cut to
    100,000 bp through ``tsta-torch psa --json``, whose plane the card
    holds, so it runs unchunked on the traced DP at its plan's 98 shards
    and K3, the launch counters and the plain calls on the card reset
    before and read after: wall, maxsorce, plan, peak device memory;
    score and corner equal to K1's, the rows re-scoring to the corner, and
    the output bytes equal to the chunked route's
    (``psa_align_traced_chunked`` at 8,192 rows a chunk); then ``tsta-torch
    psa --notrace --json`` on the pair: one K1 launch over its plan's
    shards and nothing else, wall, maxsorce and corner equal to the
    traced route's and to the plain version's on the card; then the pair's
    plane again and K3's own launch on it (CUDA events, median of 3), its
    words and count held to ``traceback.walk_staged_plain`` on that plane
    (the plain walk on the ring's schedule, which copies only its windows
    to the host), the time the kernels record's ``ms_100k``;
21. the walk probes (``walk_probes.cu``, Q2-17a, b, c, e; on no path of
    the system, ``tools/walk_probes.py``): every mode of each at its
    script's sizes, the launch counters reset before and read after, one
    line a probe: each output (every program's row and the INT32_MIN
    words) equal to the plain replay, ms (CUDA events), ns a step, the
    walker loop's instructions a step in the library's SASS, the
    refetches, the bound (the chain rule or one instruction a clock) and
    the plain replay's ms; fails on a difference, a bound beaten, a loop
    missing from the SASS, a time that does not grow with N, or 60 s;
22. rounds past 64 preds (the wide forms of ``poa_dp.cu`` and the POA
    walks: 32-bit words, 13-bit pred fields), the launch counters and the
    plain MSA calls (``counting_plain``) reset before each path and read
    after: (a) phase 7's first grown graph with node ``WIDE_AT`` raised
    by a deletion staircase (``staircase``) to in-degree 65, 128, 129 and
    1,000, its next read a deletion into that node (the pred index the
    walk enters it by must be 64 or more), DP and walk held to the plain
    versions on the card at the plan, forced D (``POA_WIDE_FORCED``) and
    forced walk plans (``POA_WALK_FORCED_WIDE``, R = 0 among them) with
    the replay's counters; then that graph at 129 as a chunked round
    (``chunking_budget``), equal to the plain chunked round and to the
    unchunked one, its pieces held by ``hold_round``; (b) 3 x 50 kbp with
    a 65-pred staircase at node 25,000 from round 1 on (``staircased``)
    through ``align_seqs(kernel="cuda")`` and ``align_seqs_many`` beside
    a 5 x 5 kbp problem, every output held to the plain route on the card
    (the parent's route, timed), no plain call; each round's ``dp_ms``
    and ``walk_ms``, and round 2's DP and walk (median of 3) beside the
    16-bit build on the same reads without the staircase;
23. the meshes on the card, the launch counters and the plain calls
    (``counting_plain``, ``psa_scan.plain_calls``) reset before each path
    and read after, each path byte-equal to the meshless run: (a) phase
    9's 3 x 50 kbp reads through ``align_seqs(mesh=make_mesh(1, K,
    [cuda:0] * K))`` at K = 8 and 16 (``MESH_ONE_CARD_K``), one
    ``poa_dp.cu`` launch at D = K and one walk a round; (b) the
    column-window wavefront (``parallel/msa_longseq.py``): first on phase
    7's first grown graph over 3 windows, its cells (every window's words,
    scores, ring and edges) and walks held to their plain versions on the
    card, then the cells of round 2 of phase 9's reads over 2 windows of
    24,576 columns (12 shards a cell) held to the plain forward on the
    card, then ``align_seqs(link=LocalLink([cuda:0] * K))`` on phase 9's
    reads at K = 1, 2 and 4 windows, a ``poa_dp.cu`` launch a cell
    (words, the checkpoint at its window's last column) and a
    ``poa_walk_bounded.cu`` launch a window walked: each window's DP and
    walk ms (CUDA events), the round-2 cells' bound, the walls;
    (c) ``align_seqs_multihost`` as 2 and 4 processes on cuda:0 over gloo
    (``jax`` and ``tsta_tpu`` blocked in each), one window a rank: each
    rank's output digest, wall, window times, launches (one
    ``poa_dp.cu`` launch a cell and one ``poa_walk_bounded.cu`` launch a
    walk of its window, nothing else), plain calls (``counting_plain``)
    and peak device memory; (d) phase 5's 128 x 10,240 bp score-only and 32 x
    10 kbp traced batches shared over ``make_mesh(4, 1, [cuda:0] * 4)``:
    one K1 launch a share, K2 and K3 at least one a share, every score,
    corner and alignment equal to phase 5's; (e) the 3 x 50 kbp run with
    ``TSTA_HBM_BUDGET_GB=4`` (chunked) and ``TSTA_POA_PROFILE=1``, its
    ``[poa_chunked]`` lines printed, equal to phase 9's;
24. the ring across cards and processes (``psa_dp.cu``'s linked build,
    one launch a card, the packets at a card's right edge published into
    the next card's link in mapped host memory,
    ``psa_ring.run_ring_cards``): (a) the kernel over 2 and 4 cards of
    cuda:0 at the cards' plan against its plain version (``run_ring_cards``
    over as many CPU devices: ``ring_card_plain`` card by card, on the
    host), T = 256, on the example and on the
    200 kbp pair's ``a`` against two row blocks of its ``b`` (the kernels
    record's times: each launch by CUDA events, summed): every shard's
    best, corner and packets and every packet of every link; (b) the
    whole 200 kbp pair over 2 and 4 cards of cuda:0, the launch counters
    and the plain calls reset before and read after (one launch a card,
    nothing else, no plain call), best and corner equal to phase 14's K1,
    then 2 more runs, each launch's median; (c)
    ``align_long_ring_ranks`` on the example as 2 processes on cuda:0
    over gloo and a link rank 0 makes (``jax`` and ``tsta_tpu`` blocked), equal
    to (a); (d) a mesh of two distinct cards where the host has them,
    else a line saying it did not run.

A ``done`` line gives the script's wall, a ``walk_bounds`` line each PSA
walk's time beside its two bounds.  The last three lines are the
kernels record (each kernel's launches on
its main path, error against its plain version, ms, plain ms, bound and
what bounds it, and for the walks their chain bound: the longest walk's
steps at one dependent shared-memory load, ``CHAIN_CYCLES`` at the
boost clock, each (a POA walk's chain is its moves plus its pred moves,
two dependent loads a pred move, from its counters; a wide walk's is
one load a move, ``L2_CYCLES`` for a miss or a pred past the staged
head, from the replay; the wide DPs' operations at the issue rate,
``poa_wide_bound``), and for the PSA walks their issue bound, the most
steps a walker thread takes at the fewest instructions a step of any PSA
walk's step loops (each computes the same step; each kernel's own count
beside it), one a clock (``issue_bound``); K1 twice, at 128 x
10,240 bp and at one pair, the ``--notrace`` example; the probes on no
path: the dtype-max probe's int32 form and each walk probe's fullest mode,
every form or mode beside it), the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no result, without
CUDA or outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "example_big")
SEED = 20261016
# the JAX native engine on the example's reads (CPU run)
EXAMPLE_MSA = {"rounds": [-5451, -3101, -1776, -870],
               "graph_len": [6885, 8599, 10130, 11468],
               "add_len": [1885, 1714, 1531, 1338]}
PSA_KERNELS = ("psa_dp_score", "psa_dp_traced", "psa_walk")
EDIT = (0, -1, -1, 0)   # edit scoring: the corner is minus the edit distance
EDIT_FLAGS = ["-M", "0", "-X", "-1", "-E", "-1", "-O", "0"]
CHUNK_KERNELS = ("poa_dp_chunk", "poa_dp_window", "poa_walk_bounded")
BUDGET_50K = 4 * 2 ** 30   # cuts the 3 x 50 kbp rounds into 8,192-row chunks
# the least time the card could take for a kernel's work: its bytes (each
# input read once, each output written once) over the H100 SXM's HBM3
# rate, or its integer operations over the int32 rate of its CUDA cores
# (132 SMs x 64 INT32 lanes x 1.98 GHz boost), whichever is larger
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per cell, counted from the kernels' sources: the PSA
# DP's E, F, H and running max (K1), plus the cell code (K2); a walk
# step; the POA DP per valid pred (E candidate, H and E first-max
# updates) and per cell (diagonal, C, F, H, running max, strip max),
# plus the word and its flags
OPS_PSA_CELL, OPS_PSA_CODE, OPS_WALK_STEP = 12, 6, 8
# a walk is one dependent chain: its least time is its longest walk's
# steps, each at least one dependent shared-memory load (~30 cycles) at
# the H100's boost clock; the kernels record keeps the bytes/operations
# bound beside it.  The phase lengths of the walks' S sweep.
CHAIN_CYCLES, SM_CLOCK_HZ = 30, 1.98e9
# a wide POA walk's move that reads device memory (a miss's word, or a
# pred past the row's staged head) waits at least an L2 hit: taken as 200
# cycles, a floor, not a measured figure
L2_CYCLES = 200
WALK_S_SWEEP = (32, 64, 128)
# the PSA walks' kernels, whose step loops give their issue bounds
WALK_KERNELS = ("psa_walk", "psa_walk_bounded", "psa_walk_pair2")
# the difference method computes K1's function: OPS_PSA_CELL per cell, at
# two cells per s16x2 instruction
CELLS_PER_S16X2 = 2
# a DPX instruction (VIADDMNMX, max(a + b, c); VIMNMX3, max(a, b, c))
# issues two of a cell's OPS_PSA_CELL operations as one
OPS_PER_DPX = 2
# The score-only DP's bound by instruction class (K1, the ring, Q2-15,
# Q2-11 and, at CELLS_PER_S16X2 cells an instruction, Q2-9): of
# OPS_PSA_CELL operations a cell, three pairs are one DPX instruction each
# (E's add and max; the F prefix's add and max; H's two maxes:
# psa_dp_score.cuh), the other six one instruction each.  Every
# instruction takes an issue slot, and an SM's four schedulers issue one
# warp instruction (32 lanes) a clock each, whatever its class: a plain
# int32 max issues ~117 lanes a clock an SM on the card (the dtype-max
# probe), past the 64 of INT32_OPS_PER_S, so the operations at that rate
# are not a floor.  DPX issues at ~57 lanes a clock (the probe), so
# counts at INT32_OPS_PER_S.
SCHED_LANES_PER_S = 132 * 128 * 1.98e9
DPX_PSA_CELL = 3
INSTR_PSA_CELL = OPS_PSA_CELL - DPX_PSA_CELL * (OPS_PER_DPX - 1)
D57 = [(57, -1, -1, 0), (2, -57, -2, -4)]   # the int16 gate's edge sets
# the opt-in layouts' forced shards (phases 17 and 18)
LAYOUT_FORCED_D = (1, 2, 8)
OPS_POA_PRED, OPS_POA_CELL, OPS_POA_WORD = 9, 12, 8
CHUNK_T_SWEEP = (16, 32, 64, 128, 256)   # packet heights of the chunk DP's sweep
# the chunk DP's 65,536 x 200,064 launch in PR 10 (NVIDIA H100 80GB HBM3,
# 700 W), against which phase 15 prints its own
PR10_CHUNK_MS = 108.78
# phase 20's traced mid-length pair: bp of each read, and the rows a chunk
# of the chunked route it is held to
TRACED_MID_BP, TRACED_MID_MC = 100_000, 8192
# the traced DP's plan sweep: the least columns a thread, blocks an SM
TRACED_MIN_W_SWEEP, TRACED_PER_SM_SWEEP = (4, 8), (1, 2)
# the score-only DP's: the least columns a thread, blocks an SM, and at one
# pair the rows a packet
SCORE_MIN_W_SWEEP, SCORE_PER_SM_SWEEP, SCORE_T_SWEEP = (2, 4, 8), (1, 2), (
    16, 32, 64)
# columns a thread and nodes a packet of the POA DP's plan sweep
POA_S_SWEEP, POA_T_SWEEP = (8, 16, 32), (16, 32, 64)
# phase 7's forced shards (D, T, G) on its 2,048-column rounds: G blocks
# (None: one a shard), fewer walking several shards each
POA_FORCED = ((2, 16, None), (3, 1, None), (5, 32, None), (5, 16, 2),
              (3, 1, 1))
# phase 7's forced POA walk plans (S, R, threads), R = 0 every move a miss
POA_WALK_FORCED = ((32, 0, 128), (8, 0, 64), (16, 64, 96), (64, 256, 256))
# phase 7's wide round: a read past 132 shards of 8,192 columns
POA_WIDE_READ = 1_100_000
EXAMPLE_MSA_SHA256 = ("9e0fb0926e830ff30b0122827c6ee184"
                      "2ad36f0eab7b90b84292d06f98c7ca72")
# phase 22: the in-degrees its staircases raise one node of phase 7's
# grown graphs to, that node (a topo position of read 0's chain), and the
# 3 x 50 kbp graph's staircase; the wide DP's forced (D, T, G) and the
# wide walks' forced plans (S, R, threads), R = 0 every move a miss
WIDE_IN, WIDE_AT, WIDE_50K = (65, 128, 129, 1000), 1200, (65, 25000)
POA_WIDE_FORCED = ((2, 16, None), (3, 1, None), (5, 32, None), (5, 16, 2))
POA_WALK_FORCED_WIDE = ((32, 0, 128), (8, 0, 64), (16, 64, 96),
                        (64, 207, 256))
# phase 23: the one-card seq axes (a 50 kbp round pads to at most 8,192
# columns a shard at K >= 7), the wavefront's windows, the processes, the
# data shares, and the budget (GiB) that chunks the 3 x 50 kbp rounds
MESH_ONE_CARD_K, MESH_WINDOWS, MESH_RANKS, MESH_DATA = (8, 16), (1, 2, 4), (
    2, 4), 4
MESH_BUDGET_GB = "4"
# a rank of phase 23 (c): one window of each round of the 3 x 50 kbp run
# on cuda:0, jax and the JAX package blocked
RANK_CHILD = r"""
import json, sys, time
BLOCKED = ("jax", "jaxlib", "tsta_tpu")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("import blocked: " + name)
sys.meta_path.insert(0, _Block())
import torch
import chip_smoke
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.ops import _kernels, msa_native, psa_scan
from tsta_tpu_torch.parallel import mesh, msa_multihost
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.zeros(1, device=dev)
_kernels._lib()
assert mesh.maybe_init_distributed()
seqs = chip_smoke.long_reads()
stats = []
_kernels.reset_launches()
torch.cuda.synchronize()
t0 = time.perf_counter()
with chip_smoke.counting_plain() as calls:
    out = msa_multihost.align_seqs_multihost(seqs, AlignParams(), device=dev,
                                             stats=stats)
    torch.cuda.synchronize()
wall = time.perf_counter() - t0
rank, size = msa_multihost.world()
print("RANK " + json.dumps({
    "rank": rank, "size": size, "wall_s": wall,
    "digest": chip_smoke.msa_digest(out),
    "windows": [st["windows"] for st in stats],
    "launches": {k: v for k, v in _kernels.launches.items() if v},
    "plain_rounds": msa_native.plain_rounds,
    "plain_calls": calls,
    "psa_plain_calls": psa_scan.plain_calls,
    "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    "blocked_clean": not [k for k in sys.modules
                          if k.split(".")[0] in BLOCKED]}), flush=True)
"""


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + fields,
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def golden_example():
    """The reference's example reads: the golden alignment's rows with
    the gaps removed."""
    with open(os.path.join(GOLDEN, "psa_default.out"), "rb") as f:
        lines = f.read().split(b"\n")
    if len(lines) != 4 or lines[0] != b">1" or lines[2] != b">2":
        raise RuntimeError("unexpected golden layout")
    return lines[1].replace(b"-", b""), lines[3].replace(b"-", b"")


def example_msa_reads():
    """The reference's MSA example reads: rows >1..>5 of the golden
    compat alignment with the gaps removed."""
    with open(os.path.join(GOLDEN, "msa_default.out"), "rb") as f:
        lines = f.read().split(b"\n")
    return [lines[lines.index(b">%d" % k) + 1].replace(b"-", b"")
            for k in range(1, 6)]


def long_reads(seed=7, length=50000):
    """3 x 50 kbp, as ``bench.stage_msa_50k`` makes them (seed 7); with
    seed 13 and 200,000 bp, ``bench.stage_msa_200k``'s 3 x 200 kbp."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(bases, length).tobytes()

    def mut(s, rate):
        s = np.frombuffer(s, np.uint8).copy()
        m = rng.random(len(s)) < rate
        s[m] = bases[rng.integers(0, 4, m.sum())]
        return np.delete(s, rng.integers(0, len(s), len(s) // 50)).tobytes()

    return [base, mut(base, 0.05), mut(base, 0.08)]


def fleet_problem(seed):
    """One 5 x 5 kbp problem of ``bench.stage_msa_fleet``."""
    import numpy as np
    r = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    base = r.choice(bases, 5000).tobytes()
    seqs = [base]
    for _ in range(4):
        s = np.frombuffer(base, np.uint8).copy()
        m = r.random(len(s)) < 0.05
        s[m] = bases[r.integers(0, 4, m.sum())]
        seqs.append(np.delete(s, r.integers(0, len(s), len(s) // 50))
                    .tobytes())
    return seqs


def msa_cells(seqs, out) -> int:
    """DP cells of a progressive run: the graph entering each round times
    that round's read length (as the bench counts them)."""
    glen = [len(seqs[0])] + out.graph_len[:-1]
    return sum(g * len(s) for g, s in zip(glen, seqs[1:]))


def msa_digest(out) -> str:
    """sha256 of an MsaOutput's rows, consensus, round scores, graph and
    add lengths."""
    h = hashlib.sha256(b"\n".join(out.rows) + b"|" + out.consensus)
    h.update(json.dumps([out.round_scores, out.graph_len,
                         out.add_len]).encode())
    return h.hexdigest()


def max_err(got, want) -> int:
    """Largest absolute difference, in chunks so the int64 copies stay
    small on a multi-GB plane."""
    import torch
    if got.shape != want.shape:
        raise AssertionError("shape %s != %s" % (tuple(got.shape),
                                                 tuple(want.shape)))
    g, w = got.reshape(-1), want.reshape(-1)
    err, step = 0, 1 << 25
    for k in range(0, g.numel(), step):
        d = g[k:k + step].to(torch.int64) - w[k:k + step].to(torch.int64)
        err = max(err, int(d.abs().max()))
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The kernels record's bound fields for work of ``nbytes`` bytes
    and ``ops`` integer operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def score_bound(nbytes: float, cells: float, per_instr: int = 1) -> dict:
    """The kernels record's bound fields for a score-only DP over
    ``cells`` cells moving ``nbytes`` bytes, ``per_instr`` cells an
    instruction: its INSTR_PSA_CELL instructions a cell at the issue rate
    or its DPX_PSA_CELL DPX instructions at the DPX rate, whichever takes
    longer, against the bytes.  ``bound_ms_scalar`` keeps the rule before
    it, OPS_PSA_CELL operations a cell at INT32_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(INSTR_PSA_CELL * cells / SCHED_LANES_PER_S,
                DPX_PSA_CELL * cells / INT32_OPS_PER_S) / per_instr * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(OPS_PSA_CELL * cells),
            "instructions": int(INSTR_PSA_CELL * cells / per_instr),
            "bound_ms_scalar": max(t_bytes, OPS_PSA_CELL * cells / per_instr
                                   / INT32_OPS_PER_S * 1e3)}


def poa_wide_bound(nbytes: float, ops: float) -> dict:
    """The kernels record's bound fields for a wide POA kernel moving
    ``nbytes`` bytes with ``ops`` integer operations, by instruction
    class: ``poa_dp.cu`` and the walks use no DPX instruction, so each
    operation is one instruction at the issue rate (SCHED_LANES_PER_S).
    ``bound_ms_scalar`` keeps the rule of :func:`bound`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCHED_LANES_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops),
            "bound_ms_scalar": bound(nbytes, ops)["bound_ms"]}


def chain_bound(steps: int) -> dict:
    """The chain bound of a walk whose longest chain has ``steps`` steps."""
    return {"chain_bound_ms": steps * CHAIN_CYCLES / SM_CLOCK_HZ * 1e3,
            "chain_steps": steps}


def issue_bound(per_step: float, steps: int) -> dict:
    """The issue bound of a PSA walk: ``steps``, the most steps one walker
    thread takes (the longest walk; in the two-pair walk its block's two
    walks together), at ``per_step`` instructions a step (the fewest of
    any PSA walk's step loops in the library's SASS, a pair-step in the
    two-pair loop, ``walk_probes.walk_sass_steps``: each loop computes the
    same step), one instruction a clock."""
    return {"issue_bound_ms": steps * per_step / SM_CLOCK_HZ * 1e3,
            "issue_per_step": per_step, "issue_steps": steps}


def poa_walk_record(counts, maxdist: int, max_in: int,
                    past_head: int | None = None) -> dict:
    """A POA walk's plan (S, R, threads), its counters (moves, pred
    moves, misses, phases) and its chain bound.  The 16-bit walks: each
    move loads its word and a pred move then the pred the word names, two
    dependent loads, so the chain is moves + pred moves loads at
    ``CHAIN_CYCLES`` each.  The wide walk (``past_head`` given: its pred
    moves past a row's staged head, from the replay) loads the head with
    the word, one shared load a move, and from device memory, at
    ``L2_CYCLES``, a missed move's word and a pred past the head."""
    from tsta_tpu_torch.ops import msa_poa
    steps, pred_moves, misses, phases = (int(x) for x in counts)
    rec = {"plan": list(msa_poa.poa_walk_plan(maxdist, max_in)),
           "counts": {"moves": steps, "pred_moves": pred_moves,
                      "misses": misses, "phases": phases}}
    if past_head is None:
        return {**rec, **chain_bound(steps + pred_moves)}
    cycles = ((steps - misses) * CHAIN_CYCLES
              + (misses + past_head) * L2_CYCLES)
    rec["counts"]["past_head"] = past_head
    return {**rec, "chain_bound_ms": cycles / SM_CLOCK_HZ * 1e3,
            "chain_steps": steps}


def wide_walk_record(kernel_counts, words, preds, row: int, j: int,
                     maxdist: int, base: int = 0, col0: int = 0) -> dict:
    """:func:`poa_walk_record` of a wide walk from (row, j) at its plan,
    its pred moves past the staged head counted by the replay of that
    plan (``poa_walk_staged_plain``), whose counters must equal the
    kernel's ``kernel_counts``."""
    from tsta_tpu_torch.ops import msa_poa
    S, R, _ = msa_poa.poa_walk_plan(maxdist, preds.shape[1])
    tally = {}
    _, _, rc = msa_poa.poa_walk_staged_plain(words, preds, row, j, 0, S, R,
                                             base, col0, tally=tally)
    if rc.tolist() != list(kernel_counts):
        raise AssertionError("wide walk: counters %s, replay %s"
                             % (list(kernel_counts), rc.tolist()))
    return poa_walk_record(kernel_counts, maxdist, preds.shape[1],
                           tally["past_head"])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int, warm: bool = True):
    """Median milliseconds of ``fn`` over ``reps`` runs (after one warm-up
    when ``warm``), timed with CUDA events on the current stream, and the
    last run's result.  Each run's result is released before the next
    starts, so the caching allocator hands the next run the same blocks, as
    on the main path, and no run waits on a fresh device allocation."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = None
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def random_pairs(rng, lengths, similar):
    """Seeded pairs; ``similar`` ones are ~12% substituted and ~3%
    indel copies, the rest independent."""
    import numpy as np
    pairs = []
    for k, (n, m) in enumerate(lengths):
        a = rng.integers(0, 4, n).astype(np.uint8)
        if similar(k):
            b = a.copy()
            b[rng.integers(0, n, n // 8)] = rng.integers(0, 4, n // 8)
            b = np.delete(b, rng.integers(0, n, n // 60))
            b = np.insert(b, rng.integers(0, len(b), n // 60),
                          rng.integers(0, 4, n // 60).astype(np.uint8))
            b = np.resize(b, m)
        else:
            b = rng.integers(0, 4, m).astype(np.uint8)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        pairs.append((acgt[a], acgt[b]))
    return pairs


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

    from tsta_tpu_torch import AlignParams, cli
    from tsta_tpu_torch.ops import _kernels, psa_diff, psa_scan
    from tsta_tpu_torch.ops import traceback as tb
    from tsta_tpu_torch.parallel import batch as pbatch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    params = AlignParams()
    p = psa_scan.as_params(params)
    rng = np.random.default_rng(SEED)
    kind = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")

    # 1. device
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit({"phase": "device", "name": kind, "smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1]})

    # 2. build
    t0 = time.perf_counter()
    _kernels.build()
    info = _kernels.build_info
    from tsta_tpu_torch.tools import walk_probes
    walk_sass = walk_probes.walk_sass_steps(walk_probes.library_sass())
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(info["seconds"], 3),
          "library": os.path.relpath(info["path"], ROOT),
          "flags": " ".join(_kernels.NVCC_FLAGS),
          "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                    if "Used" in ln or "spill" in ln],
          "walk_step_loops": walk_sass})
    if any(not walk_sass.get(k, {}).get("per_step") for k in WALK_KERNELS):
        raise AssertionError("a PSA walk's step loop is missing from the "
                             "SASS: %s" % walk_sass)

    # 3. each kernel against its plain version, on the card
    errs = {k: 0 for k in PSA_KERNELS}
    lens_mixed = [(int(rng.integers(100, 3001)), int(rng.integers(100, 3001)))
                  for _ in range(64)]
    batches = [random_pairs(rng, lens_mixed, lambda k: k % 2 == 0),
               random_pairs(rng, [(40000, 39700)], lambda k: True)]
    for pairs in batches:
        a, b, lens = psa_diff.pack_pairs(pairs, dev)
        got = psa_diff.dp_packed(a, b, lens, p)
        want = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], p)[:2]
        torch.cuda.synchronize()
        errs["psa_dp_score"] = max(errs["psa_dp_score"],
                                   *(max_err(g, w) for g, w in zip(got, want)))
    pairs = random_pairs(rng, [(int(rng.integers(2000, 4001)),
                                int(rng.integers(2000, 4001)))
                               for _ in range(4)], lambda k: k < 3)
    pairs = [(x, y) if len(x) >= len(y) else (y, x) for x, y in pairs]
    a, b, nm = psa_diff.pack_pairs(pairs, dev, traced=True)
    ks, kc, kplane = psa_diff.dp_packed(a, b, nm, p, traced=True)
    ps, pc, pplane = psa_scan.scan_rows(a, b, nm[:, 0], nm[:, 1], p, True)
    kw, kcnt = tb.walk_packed(kplane, nm)
    pw, pcnt = tb.walk_packed_plain(kplane, nm)
    torch.cuda.synchronize()
    errs["psa_dp_traced"] = max(max_err(ks, ps), max_err(kc, pc),
                                max_err(kplane, pplane))
    errs["psa_walk"] = max(max_err(kw, pw), max_err(kcnt, pcnt))
    emit({"phase": "kernels", "max_abs_err": errs,
          "score_only_pairs": [len(x) for x in batches],
          "traced_lengths": nm.tolist(), "plane": list(kplane.shape)})
    if any(errs.values()):
        raise AssertionError("kernel differs from its plain version: %s"
                             % errs)
    del kplane, pplane

    # 4. the main path through the CLI
    s1, s2 = golden_example()
    with open(os.path.join(GOLDEN, "psa_default.out"), "rb") as f:
        gold = f.read()
    with open(os.path.join(GOLDEN, "psa_x3.out"), "rb") as f:
        gold_x3 = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "seqa1.fa"), os.path.join(tmp, "seqb1.fa")
        with open(fa, "wb") as f:
            f.write(b">seqa1\n" + s1 + b"\n")
        with open(fb, "wb") as f:
            f.write(b">seqb1\n" + s2 + b"\n")
        out = os.path.join(tmp, "out.txt")
        argv = ["psa", "-1", fa, "-2", fb, "--device", "cuda"]
        buf = io.StringIO()
        p0 = start()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc1 = cli.main(argv + ["-o", out])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            traced_launches, _ = stop(p0)
            _kernels.reset_launches()
            t1n = time.perf_counter()
            rc2 = cli.main(argv + ["--notrace"])
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        notrace_launches, plain_main = stop(p0)
        launches = {k: traced_launches[k] + notrace_launches[k]
                    for k in traced_launches}
        with open(out, "rb") as f:
            traced_ok = f.read() == gold
        stdout = buf.getvalue().split()
        t3 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tsta_tpu_torch", "psa", "-X", "-3",
             "-1", fa, "-2", fb, "-o", out + ".x3", "--json",
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        t4 = time.perf_counter()
        if proc.returncode != 0:
            raise RuntimeError("tsta_tpu_torch psa -X -3 failed:\n"
                               + proc.stderr)
        x3 = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(out + ".x3", "rb") as f:
            x3_ok = f.read() == gold_x3
    # K1's plan for the --notrace pair: one launch over several SMs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_pad_ex = -(-max(len(s1), len(s2)) // psa_diff.LANES) * psa_diff.LANES
    plan_1 = psa_diff.score_plan(1, n_pad_ex, sms)
    score_plan_1 = {**dict(zip("DCWT", plan_1)), "n_pad": n_pad_ex,
                    "layout_equals_plan": _kernels.psa_dp_layout(
                        1, n_pad_ex, sms) == plan_1}
    emit({"phase": "main_path", "rc": [rc1, rc2], "stdout": stdout,
          "golden_identical": traced_ok, "x3_golden_identical": x3_ok,
          "launches": launches, "x3_launches": x3["launches"],
          "psa_traced_wall_s": round(t1 - t0, 4),
          "psa_notrace_wall_s": round(t2 - t1n, 4),
          "notrace_launches": {k: v for k, v in notrace_launches.items()
                               if v},
          "plain_calls": plain_main, "notrace_plan": score_plan_1,
          "x3_subprocess_wall_s": round(t4 - t3, 4),
          "x3_align_wall_s": x3["wall_s"],
          "example": [len(s1), len(s2)]})
    if (rc1, rc2) != (0, 0) or stdout != ["maxsorce=-5", "maxsorce=-5"]:
        raise AssertionError("main path stdout %s rc %s" % (stdout,
                                                              (rc1, rc2)))
    if not (traced_ok and x3_ok):
        raise AssertionError("output differs from the golden files")
    if min(launches[k] for k in PSA_KERNELS) < 1 or min(
            x3["launches"]["psa_dp_traced"], x3["launches"]["psa_walk"]) < 1:
        raise AssertionError("a kernel of the main path never launched: "
                             "%s %s" % (launches, x3["launches"]))
    if (notrace_launches["psa_dp_score"] != 1 or plain_main
            or sum(notrace_launches.values()) != 1 or plan_1[0] < 2
            or not score_plan_1["layout_equals_plan"]):
        raise AssertionError("--notrace is not one K1 launch over several "
                             "SMs: %s, plain calls %d, plan %s"
                             % (notrace_launches, plain_main, score_plan_1))

    # 5. batches at the users' scale
    ex = (np.frombuffer(s1, np.uint8), np.frombuffer(s2, np.uint8))
    pairs = [ex] + random_pairs(rng, [(10240, 10240)] * 127,
                                lambda k: k % 2 == 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pbatch.align_batch(pairs, params, device=dev)
    t_batch = time.perf_counter() - t0
    a, b, lens = psa_diff.pack_pairs(pairs, dev)
    want_s, want_c, _ = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1], p)
    got_s = torch.tensor([r.score for r in res], dtype=torch.int32)
    got_c = torch.tensor([r.last for r in res], dtype=torch.int32)
    score_err = max(max_err(got_s, want_s.cpu()),
                    max_err(got_c, want_c.cpu()))
    cells_score = sum(len(x) * len(y) for x, y in pairs)

    tpairs = [ex] + random_pairs(rng, [(10000, 10000)] * 31,
                                 lambda k: k % 2 == 0)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tres = pbatch.align_batch_traced_device(tpairs, params, device=dev)
    t_traced = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rescored = [tb.score_alignment(aln.a_row, aln.b_row, params) == c
                for _, c, aln in tres]
    slot0 = b">1\n" + tres[0][2].a_row + b"\n>2\n" + tres[0][2].b_row
    cells_traced = sum(len(x) * len(y) for x, y in tpairs)
    emit({"phase": "batches", "score_only_pairs": len(pairs),
          "slot0_score": res[0].score, "score_only_max_abs_err": score_err,
          "score_only_e2e_s": round(t_batch, 4),
          "score_only_e2e_gcups": round(cells_score / t_batch / 1e9, 3),
          "traced_pairs": len(tpairs), "traced_rescored_ok": all(rescored),
          "traced_slot0_golden_identical": slot0 == gold,
          "traced_e2e_s": round(t_traced, 4),
          "traced_e2e_gcups": round(cells_traced / t_traced / 1e9, 3),
          "traced_peak_device_gb": round(peak_gb, 3), "smi": smi_line})
    if res[0].score != -5 or score_err or not all(rescored) \
            or slot0 != gold:
        raise AssertionError("batch results wrong")

    # 6. kernel and plain version at the main path's shapes: times, and
    # exact equality of every output of the timed runs
    times = {}
    ms, got = cuda_ms(lambda: psa_diff.dp_packed(a, b, lens, p), 3)
    pms, want = cuda_ms(lambda: psa_scan.scan_rows(a, b, lens[:, 0],
                                                   lens[:, 1], p), 1, False)
    times["psa_dp_score"] = {
        "shape": "128 x 10240 score-only", "ms": ms, "plain_ms": pms,
        "gcups": cells_score / ms / 1e6, "plain_gcups": cells_score / pms / 1e6,
        "max_abs_err": max(score_err, *(max_err(g, w)
                                        for g, w in zip(got, want[:2]))),
        **score_bound(nbytes(a, b, lens, *got), cells_score)}
    del a, b, lens, got, want
    # K1 at one pair, the --notrace example: kernel and plain version
    a, b, lens = psa_diff.pack_pairs([ex], dev)
    cells_ex = len(ex[0]) * len(ex[1])
    ms, got = cuda_ms(lambda: psa_diff.dp_packed(a, b, lens, p), 3)
    pms, want = cuda_ms(lambda: psa_scan.scan_rows(a, b, lens[:, 0],
                                                   lens[:, 1], p), 1, False)
    times["psa_dp_score 1 pair"] = {
        "shape": "1 pair, the example, %d x %d bp score-only" % (
            len(ex[0]), len(ex[1])), "ms": ms, "plain_ms": pms,
        "gcups": cells_ex / ms / 1e6,
        "max_abs_err": max(max_err(g, w) for g, w in zip(got, want[:2])),
        **score_bound(nbytes(a, b, lens, *got), cells_ex)}
    del a, b, lens, got, want
    # the score-only DP's plan and its sweep at 1, 32 and 128 pairs
    score_plans = {}
    for label, group in (("1 x 10 kbp (the example)", [ex]),
                         ("32 x 10240", pairs[:32]), ("128 x 10240", pairs)):
        a, b, lens = psa_diff.pack_pairs(group, dev)
        want = psa_diff.dp_packed(a, b, lens, p)
        score_plans[label] = dict(zip(("plan", "sweep"), score_sweep(
            a, b, lens, p, want)))
        del a, b, lens, want
    times["psa_dp_score 1 pair"]["plan"] = score_plans[
        "1 x 10 kbp (the example)"]["plan"]
    times["psa_dp_score"]["plan"] = score_plans["128 x 10240"]["plan"]
    for label, group in (("32 x 10 kbp", tpairs), ("1 x 10 kbp", [ex])):
        a, b, nm = psa_diff.pack_pairs(group, dev, traced=True)
        cells = sum(len(x) * len(y) for x, y in group)
        ms, (ks, kc, plane) = cuda_ms(
            lambda: psa_diff.dp_packed(a, b, nm, p, True), 2)
        pms, (ps, pc, pplane) = cuda_ms(
            lambda: psa_scan.scan_rows(a, b, nm[:, 0], nm[:, 1], p, True), 1,
            False)
        # per pair, so the int64 difference stays small
        dp_err = max(max_err(ks, ps), max_err(kc, pc),
                     *(max_err(g, w) for g, w in zip(plane, pplane)))
        del pplane
        wms, (kw, kcnt) = cuda_ms(lambda: tb.walk_packed(plane, nm), 2)
        wpms, (pw, pcnt) = cuda_ms(lambda: tb.walk_packed_plain(plane, nm), 1,
                                   False)
        walk_sweep, walk_err = {}, 0
        if group is tpairs:   # phase 18 holds the two-pair walk to it
            walk_plain = (pw, pcnt, wpms)
            for S in WALK_S_SWEEP:   # K3's phase length, every output equal
                walk_sweep[S], (sw, sc) = cuda_ms(
                    lambda: tb.walk_packed(plane, nm, S=S), 3)
                walk_err = max(walk_err, max_err(sw, pw), max_err(sc, pcnt))
        plan, sweep = traced_sweep(a, b, nm, p, (ks, kc, plane))
        times["psa_dp_traced " + label] = {
            "shape": label + " traced", "ms": ms, "plain_ms": pms,
            "gcups": cells / ms / 1e6, "plain_gcups": cells / pms / 1e6,
            "max_abs_err": max(dp_err, sweep["max_abs_err"]),
            "plan": plan, "sweep": sweep,
            **bound(nbytes(a, b, nm, ks, kc, plane),
                    (OPS_PSA_CELL + OPS_PSA_CODE) * plane.numel())}
        steps = int(kcnt.sum())   # one plane byte read per move
        times["psa_walk " + label] = {
            "shape": label, "ms": wms, "plain_ms": wpms,
            "max_abs_err": max(max_err(kw, pw), max_err(kcnt, pcnt),
                               walk_err),
            "plan": k3_plan(len(group)), "s_sweep_ms": walk_sweep,
            **chain_bound(int(kcnt.max())),
            **bound(steps + nbytes(nm, kw, kcnt), OPS_WALK_STEP * steps)}
        del a, b, nm, plane, ks, kc, ps, pc, kw, kcnt, pw, pcnt
    times["psa_walk traced batch"], short_batch = traced_batch_walks(
        dev, smi_line, params, p)
    emit({"phase": "timings", "times": times, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    emit({"phase": "psa_traced_plan", "smi": smi_line, **{
        label: {k: times["psa_dp_traced " + label][k]
                for k in ("ms", "plan", "sweep")}
        for label in ("32 x 10 kbp", "1 x 10 kbp")}})
    emit({"phase": "psa_score_plan", "smi": smi_line, **score_plans})
    bad = {k: t["max_abs_err"] for k, t in times.items() if t["max_abs_err"]}
    if bad:
        raise AssertionError("kernel differs from its plain version at the "
                             "main path's shapes: %s" % bad)

    msa_launches, poa_times, res_50k = msa_phases(dev, smi_line)
    launches.update(poa_dp=msa_launches["poa_dp"],
                    poa_walk=msa_launches["poa_walk"])
    chunk_launches, chunk_times, k1 = chunked_phases(dev, smi_line, res_50k)
    launches.update(chunk_launches)
    psa_launches, psa_times = psa_chunked_phases(dev, smi_line, k1)
    launches.update(psa_launches)
    edit_launches, edit_times = edit_phases(dev, smi_line, pairs)
    launches.update(edit_launches)
    int16_launches, int16_times = int16_phases(dev, smi_line, batches, pairs)
    launches.update(int16_launches)
    striped_launches, striped_times = striped_phases(
        dev, smi_line, batches, pairs, tpairs, walk_plain, short_batch)
    del short_batch
    launches.update(striped_launches)
    ring_launches, ring_times = ring_phases(
        dev, smi_line, k1, edit_times["k1_200k"], psa_times["traced_200k"],
        edit_times["traced_200k"])
    launches.update(ring_launches)
    times["psa_walk 32 x 10 kbp"].update(traced_100k_phase(dev, smi_line))
    probe_launches, probe_times = walk_probe_phase(dev, smi_line)
    launches.update(probe_launches)
    wide_launches, wide_times = wide_phases(dev, smi_line)
    launches.update(wide_launches)
    mesh_phases(dev, smi_line, res_50k, (pairs, res), (tpairs, tres))
    cards_launches, cards_times = ring_cards_phases(dev, smi_line, k1,
                                                    ring_times["psa_ring"])
    launches.update(cards_launches)

    emit({"phase": "done", "wall_s": time.perf_counter() - t_start,
          "smi": smi_line})
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    # every PSA walk computes the same step: each is charged the fewest
    # instructions a step of any of their step loops, its own beside it
    least = min(walk_sass[k]["per_step"] for k in WALK_KERNELS)
    for kernel, t in (("psa_walk", times["psa_walk 32 x 10 kbp"]),
                      ("psa_walk", times["psa_walk traced batch"]),
                      ("psa_walk", edit_times["psa_r1_walk"]),
                      ("psa_walk_bounded", psa_times["psa_walk_bounded"]),
                      ("psa_walk_pair2", striped_times["psa_walk_pair2"])):
        t.update(issue_bound(least, t.get("thread_steps", t["chain_steps"])),
                 own_per_step=walk_sass[kernel]["per_step"])
        t["walk_bound_ms"] = max(t["chain_bound_ms"], t["issue_bound_ms"])
    emit({"phase": "walk_bounds", "smi": smi_line, **{
        label: {k: t[k] for k in ("ms", "walk_bound_ms", "chain_bound_ms",
                                  "issue_bound_ms", "issue_per_step",
                                  "issue_steps", "own_per_step")}
        for label, t in (("K3 32 x 10 kbp", times["psa_walk 32 x 10 kbp"]),
                         ("K3 traced batch", times["psa_walk traced batch"]),
                         ("Q2-16", edit_times["psa_r1_walk"]),
                         ("Q2-8", psa_times["psa_walk_bounded"]),
                         ("Q2-12", striped_times["psa_walk_pair2"]))}})
    src = "tsta_tpu_torch/csrc/%s"
    launches["psa_dp_score_1pair"] = notrace_launches["psa_dp_score"]
    entries = [
        ("psa_dp_score", src % "psa_dp.cu", "tsta_tpu/ops/psa_diff.py:309",
         times["psa_dp_score"]),
        ("psa_dp_score_1pair", src % "psa_dp.cu",
         "tsta_tpu/ops/psa_diff.py:309", times["psa_dp_score 1 pair"]),
        ("psa_dp_traced", src % "psa_dp_traced.cu",
         "tsta_tpu/ops/psa_diff.py:309",
         times["psa_dp_traced 32 x 10 kbp"]),
        ("psa_walk", src % "psa_walk.cu", "tsta_tpu/ops/traceback.py:614",
         times["psa_walk 32 x 10 kbp"]),
        ("poa_dp", src % "poa_dp.cu", "tsta_tpu/ops/msa_pallas.py:58",
         poa_times["poa_dp 50 kbp round 2"]),
        ("poa_walk", src % "poa_walk.cu", "tsta_tpu/ops/msa_pallas.py:646",
         poa_times["poa_walk 50 kbp round 2"]),
        ("poa_dp_chunk", src % "poa_dp.cu", "tsta_tpu/ops/msa_pallas.py:58",
         chunk_times["poa_dp_chunk"]),
        ("poa_dp_window", src % "poa_dp.cu", "tsta_tpu/ops/msa_pallas.py:58",
         chunk_times["poa_dp_window"]),
        ("poa_walk_bounded", src % "poa_walk_bounded.cu",
         "tsta_tpu/ops/msa_pallas.py:775", chunk_times["poa_walk_bounded"]),
        ("psa_dp_chunk", src % "psa_dp_traced.cu",
         "tsta_tpu/ops/psa_pallas.py:585",
         psa_times["psa_dp_chunk"]),
        ("psa_walk_bounded", src % "psa_walk_bounded.cu",
         "tsta_tpu/ops/traceback.py:823", psa_times["psa_walk_bounded"]),
        ("psa_r1_dp", src % "psa_dp_traced.cu",
         "tsta_tpu/ops/psa_pallas.py:52",
         edit_times["psa_r1_dp"]),
        ("psa_r1_batch", src % "psa_dp.cu", "tsta_tpu/ops/psa_pallas.py:274",
         edit_times["psa_r1_batch"]),
        ("psa_dp_short", src % "psa_dp_short.cu",
         "tsta_tpu/ops/psa_pallas.py:936", edit_times["psa_dp_short"]),
        ("psa_r1_walk", src % "psa_walk.cu", "tsta_tpu/ops/traceback.py:381",
         edit_times["psa_r1_walk"]),
        ("psa_dp_diff", src % "psa_dp_diff.cu",
         "tsta_tpu/ops/psa_diff.py:104", int16_times["psa_dp_diff"]),
        ("psa_dp_striped", src % "psa_dp_striped.cu",
         "tsta_tpu/ops/psa_diff.py:543", striped_times["psa_dp_striped"]),
        ("psa_walk_pair2", src % "psa_walk_pair2.cu",
         "tsta_tpu/ops/traceback.py:723", striped_times["psa_walk_pair2"]),
        ("psa_ring", src % "psa_dp.cu", "tsta_tpu/ops/psa_ring.py:78",
         ring_times["psa_ring"]),
        ("psa_ring_linked", src % "psa_dp.cu", "tsta_tpu/ops/psa_ring.py:78",
         cards_times["psa_ring_linked"]),
        ("dtype_max_probe", src % "dtype_max_probe.cu",
         "scripts/dtype_max_probe.py:19", int16_times["dtype_max_probe"]),
        ("walk_probe_a", src % "walk_probes.cu", "scripts/walk_ablate.py:36",
         probe_times["walk_probe_a"]),
        ("walk_probe_b", src % "walk_probes.cu",
         "scripts/walk_ablate2.py:32", probe_times["walk_probe_b"]),
        ("walk_probe_c", src % "walk_probes.cu",
         "scripts/walk_ablate3.py:33", probe_times["walk_probe_c"]),
        ("walk_probe_e", src % "walk_probes.cu", "scripts/db_probe.py:14",
         probe_times["walk_probe_e"]),
        ("poa_dp_wide", src % "poa_dp.cu", "tsta_tpu/ops/msa_pallas.py:58",
         wide_times["poa_dp_wide"]),
        ("poa_walk_wide", src % "poa_walk.cu",
         "tsta_tpu/ops/msa_pallas.py:646", wide_times["poa_walk_wide"]),
        ("poa_dp_chunk_wide", src % "poa_dp.cu",
         "tsta_tpu/ops/msa_pallas.py:58", wide_times["poa_dp_chunk_wide"]),
        ("poa_dp_window_wide", src % "poa_dp.cu",
         "tsta_tpu/ops/msa_pallas.py:58", wide_times["poa_dp_window_wide"]),
        ("poa_walk_bounded_wide", src % "poa_walk_bounded.cu",
         "tsta_tpu/ops/msa_pallas.py:775",
         wide_times["poa_walk_bounded_wide"]),
    ]
    emit({"kernels": [{"name": n, "route": "cuda", "source": s,
                       "replaces": r, "launches": launches[n],
                       "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                       "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                       "bound_by": t["bound_by"], "library_ms": None,
                       "shape": t["shape"],
                       **{k: t[k] for k in ("k1_ms", "k3_ms", "ms_200k",
                                            "bound_ms_scalar",
                                            "bound_ms_200k", "gcups_200k",
                                            "k1_s_200k", "plan", "forced",
                                            "sweep", "S", "s_sweep_ms",
                                            "counts", "chain_bound_ms",
                                            "chain_steps", "issue_bound_ms",
                                            "issue_per_step", "issue_steps",
                                            "own_per_step", "walk_bound_ms",
                                            "ms_short", "k3_ms_short",
                                            "ms_short_even",
                                            "k3_ms_short_even",
                                            "ms_100k", "chain_bound_ms_100k",
                                            "ms_200k_4", "launch_ms", "shards",
                                            "iters", "modes")
                          if k in t}}
                      for n, s, r, t in entries]})
    print(smi_line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def traced_sweep(a, b, nm, params, want):
    """The traced DP's plan for a group (``psa_diff.traced_plan``, and
    whether the kernel's exported layout equals it), then the sweep: the
    same group at the D of each other plan, the least W 4 or 8 and 1 or 2
    blocks an SM (CUDA events, median of 2 after a warm-up), every output
    held to ``want`` (the plan's run)."""
    import torch

    from tsta_tpu_torch.ops import _kernels, psa_diff
    P, n_pad = a.shape
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = psa_diff.traced_plan(P, n_pad, sms)
    out = {"plan": dict(zip("DCWT", plan)), "sms": sms,
           "layout_equals_plan": _kernels.psa_dp_traced_layout(
               P, n_pad, sms) == plan, "fill_rows": (plan[0] - 1) * plan[3]}
    runs, err = {}, 0
    for min_w in TRACED_MIN_W_SWEEP:
        for per_sm in TRACED_PER_SM_SWEEP:
            D, _, W, _ = psa_diff.traced_plan(P, n_pad, sms, min_w, per_sm)
            if D not in runs:
                ms, got = cuda_ms(lambda: psa_diff.run_dp(
                    a, b, nm, params, True, D=D), 2)
                err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
                runs[D] = {"D": D, "W": W, "blocks": P * D, "ms": ms}
                del got
            runs[D].setdefault("plans", []).append(
                "min W %d, %d a SM" % (min_w, per_sm))
    plan_sweep = {"max_abs_err": err, "runs": list(runs.values())}
    if err or not out["layout_equals_plan"]:
        raise AssertionError("traced DP: the sweep's outputs differ (%d), "
                             "or the kernel's layout is not traced_plan's"
                             % err)
    return out, plan_sweep


def score_sweep(a, b, lens, params, want):
    """The score-only DP's plan for a group (``psa_diff.score_plan``, and
    whether the kernel's exported layout equals it), then the sweep: the
    same group at the D of each other plan, the least W 2, 4 or 8 and 1 or
    2 blocks an SM, and at one pair the plan's D at each packet height
    (CUDA events, median of 3 after a warm-up), every output held to
    ``want`` (the plan's run)."""
    import torch

    from tsta_tpu_torch.ops import _kernels, psa_diff
    P, n_pad = a.shape
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = psa_diff.score_plan(P, n_pad, sms)
    out = {"plan": dict(zip("DCWT", plan)), "sms": sms,
           "layout_equals_plan": _kernels.psa_dp_layout(
               P, n_pad, sms) == plan, "fill_rows": (plan[0] - 1) * plan[3]}
    runs, err = {}, 0
    for min_w in SCORE_MIN_W_SWEEP:
        for per_sm in SCORE_PER_SM_SWEEP:
            D, _, W, _ = psa_diff.score_plan(P, n_pad, sms, min_w, per_sm)
            if D not in runs:
                ms, got = cuda_ms(lambda: psa_diff.run_dp(
                    a, b, lens, params, D=D), 3)
                err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
                runs[D] = {"D": D, "W": W, "blocks": P * D, "ms": ms}
            runs[D].setdefault("plans", []).append(
                "min W %d, %d a SM" % (min_w, per_sm))
    t_runs = {}
    for T in SCORE_T_SWEEP if P == 1 else ():
        t_runs[T], got = cuda_ms(lambda: psa_diff.run_dp(
            a, b, lens, params, D=plan[0], T=T), 3)
        err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
    sweep = {"max_abs_err": err, "runs": list(runs.values()),
             "t_sweep_ms": t_runs}
    if err or not out["layout_equals_plan"]:
        raise AssertionError("score-only DP: the sweep's outputs differ "
                             "(%d), or the kernel's layout is not "
                             "score_plan's" % err)
    return out, sweep


def notrace_cli(fa, fb, pair):
    """``tsta-torch psa --notrace --json`` in this process on ``fa`` and
    ``fb``, the launch counters and the plain calls on the card reset
    before and read after: its score, corner and wall, the kernels it
    launched, the plain calls, and whether that was one K1 launch and
    nothing else; then the plain version (``psa_scan.scan_rows`` on the
    card) on ``pair``, the two reads as bytes, longer first, as the CLI
    orders them: its score, corner and seconds."""
    import torch

    from tsta_tpu_torch import cli
    from tsta_tpu_torch.io import encode_dna
    from tsta_tpu_torch.ops import psa_diff, psa_scan
    buf = io.StringIO()
    p0 = start()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["psa", "-1", fa, "-2", fb, "--device", "cuda",
                       "--notrace", "--json"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = stop(p0)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    a, b, lens = psa_diff.pack_pairs([tuple(encode_dna(x) for x in pair)],
                                     torch.device("cuda"))
    t0 = time.perf_counter()
    ps, pc, _ = psa_scan.scan_rows(a, b, lens[:, 0], lens[:, 1],
                                   (2, -5, -2, -4))
    plain_out = [int(ps[0]), int(pc[0])]
    return {"rc": rc, "wall_s": wall, "score": res["score"],
            "corner": res["corner"],
            "launches": {k: v for k, v in launches.items() if v},
            "plain_calls": plain,
            "one_k1_launch": rc == 0 and launches["psa_dp_score"] == 1
            and sum(launches.values()) == 1 and plain == 0,
            "plain": plain_out, "plain_s": time.perf_counter() - t0}


def next_round(seqs, rounds, params, dev, budget=None, stair=None):
    """The device inputs of round ``rounds + 1`` of ``seqs``, after
    ``rounds`` rounds through the kernels, planned for ``budget`` bytes
    (default: the card's); ``stair`` (k, at): read 0's chain with node
    ``at``'s in-degree raised to k (:func:`staircase`)."""
    import numpy as np
    import torch

    from tsta_tpu_torch.device import device_budget
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa
    if budget is None:
        budget = device_budget(dev)
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    if stair:
        staircase(g, *stair)
    for sno in range(1, rounds + 1):
        packed, order, _ = msa_poa.run_round(g, seqs[sno], params, dev,
                                             "cuda", budget)
        msa_native._finish_round(g, seqs[sno], sno, order,
                                 packed.cpu().numpy(), [], [], [])
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(
        g, seqs[rounds + 1], params, budget)
    predsT, pmaskT, bases, fills, N, max_in, W, order, preds = prep

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return {"tables": [put(x) for x in (predsT, pmaskT, bases.reshape(N),
                                        fills, a)],
            "lists": ([put(x) for x in msa_poa.pred_lists(preds, pmaskT)]
                      if max_in > msa_poa.MAX_IN else None),
            "order": list(order),
            "n_real": n_real, "n_nodes": len(order), "W": W, "NC": NC,
            "NWIN": NWIN, "preds": put(preds),
            "mask": put(msa_poa.sink_mask(g, order, N)),
            "shape": "%d nodes x %d columns (N %d, max_in %d, W %d)"
                     % (len(order), n, N, max_in, W)}


def poa_compare(r, params, reps: int, plain_warm: bool, forced=(),
                walk_forced=()):
    """Kernel and plain version of the POA DP and walk on one round's
    inputs: times, the DP's plan (D, C, S, T), the walk's plan, counters
    and chain bound, and the largest difference of every output;
    ``forced`` (D, T, G) triples run the DP again at those overrides, and
    ``walk_forced`` (S, R, threads) the walk, each held to the plain
    version too, the walk's counters to ``poa_walk_staged_plain``'s replay
    of that plan (a mismatch counts as a difference)."""
    import torch

    from tsta_tpu_torch.ops import msa_native, msa_poa
    args = (*r["tables"], r["n_real"], r["n_nodes"], params, r["W"])
    lists = r["lists"]
    ms, (kw, ks) = cuda_ms(lambda: msa_poa.poa_dp(*args, lists=lists), reps)
    pms, (pw, ps) = cuda_ms(lambda: msa_native.round_dp_plain(*args), 1,
                            plain_warm)
    nn = r["n_nodes"]
    dp_err = max(max_err(kw[:nn], pw[:nn]), max_err(ks, ps))
    for D, T, G in forced:
        fw, fs = msa_poa.poa_dp(*args, lists=lists, D=D, T=T, G=G)
        dp_err = max(dp_err, max_err(fw[:nn], pw[:nn]), max_err(fs, ps))
        del fw, fs
    best = msa_poa.best_sink(ps, r["mask"])
    maxdist = msa_poa.max_pred_distance(r["preds"].cpu().numpy())
    counts = torch.zeros((4,), dtype=torch.int32, device=kw.device)
    wms, kal = cuda_ms(lambda: msa_poa.poa_walk(
        kw, r["preds"], best, r["n_real"], maxdist=maxdist, counts=counts),
        reps)
    wpms, pal = cuda_ms(lambda: msa_poa.walk_plain(pw, r["preds"], best,
                                                   r["n_real"]), 1,
                        plain_warm)
    wide = lists is not None
    walk = (wide_walk_record(counts.tolist(), kw, r["preds"], int(best),
                             r["n_real"] - 1, maxdist) if wide else
            poa_walk_record(counts.tolist(), maxdist, r["preds"].shape[1]))
    walk_err = max_err(kal, pal)
    swept = []
    for S, R, threads in walk_forced:
        fc = torch.zeros((4,), dtype=torch.int32, device=kw.device)
        fal = msa_poa.poa_walk(kw, r["preds"], best, r["n_real"], S=S, R=R,
                               threads=threads, counts=fc)
        _, _, rc = msa_poa.poa_walk_staged_plain(
            kw, r["preds"], int(best), r["n_real"] - 1, 0, S, R)
        swept.append({"plan": [S, R, threads], "counts": fc.tolist()})
        walk_err = max(walk_err, max_err(fal, pal),
                       int(fc.tolist() != rc.tolist()))
    tables = r["tables"]
    n = tables[4].shape[0]
    preds_in = int(tables[1][:, :nn].sum())
    dp_ops = n * (OPS_POA_PRED * preds_in
                  + (OPS_POA_CELL + OPS_POA_WORD) * nn)
    c = walk["counts"]
    # each move reads a word, each pred move a pred; an align write a
    # consumed column
    walk_bytes = (c["moves"] * kw.element_size() + c["pred_moves"] * 4
                  + r["n_real"] * 4 + nbytes(best))
    rule = poa_wide_bound if wide else bound
    return ({"shape": r["shape"], "ms": ms, "plain_ms": pms,
             "max_abs_err": dp_err, "plan": list(msa_poa.poa_plan(n)),
             "forced": [[*msa_poa.poa_plan(n, D, T), G or D]
                        for D, T, G in forced],
             **rule(nbytes(*tables, kw, ks), dp_ops)},
            {"shape": r["shape"], "ms": wms, "plain_ms": wpms,
             "max_abs_err": walk_err, "maxdist": maxdist, **walk,
             "forced": swept,
             **rule(walk_bytes, OPS_WALK_STEP * c["moves"])})


def grown_reads(seed):
    """Phase 7's seeded reads: a 2,000 bp base and 4 copies with 240
    substitutions and 30 deletions."""
    import numpy as np
    rng = np.random.default_rng(SEED + seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 2000)
    reads = [base.tobytes()]
    for _ in range(4):
        s = base.copy()
        s[rng.integers(0, 2000, 240)] = rng.choice(acgt, 240)
        reads.append(np.delete(s, rng.integers(0, 2000, 30)).tobytes())
    return reads


def staircase(g, k: int, m: int) -> int:
    """Raise the in-degree of the node at topo position ``m`` of ``g`` to
    ``k``: edges into it from the nodes before it in topo order, nearest
    first, as reads with deletions of every length up to ~k ending at one
    base make them; the largest pred distance, and so the ring's W, stays
    about k.  Returns the node."""
    order = list(g.topo)
    v = int(order[m])
    have = {int(p) for p in g._preds[v, :int(g._ndeg[v])]}
    q = 1
    while int(g._ndeg[v]) < k:
        u = int(order[m - q])
        q += 1
        if u not in have:
            g.add_edge(u, v)
            have.add(u)
    g.toposort()
    return v


@contextlib.contextmanager
def staircased(k: int, at: int, min_len: int):
    """Within: ``PoaGraph.from_sequence`` of a read of at least
    ``min_len`` bp gives its chain with node ``at``'s in-degree raised to
    k (so every round of that problem is wide); shorter reads' chains as
    they are."""
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    orig = PoaGraph.__dict__["from_sequence"]

    def from_sequence(cls, seq, n_seq):
        g = orig.__func__(cls, seq, n_seq)
        if len(seq) >= min_len:
            staircase(g, k, at)
        return g

    PoaGraph.from_sequence = classmethod(from_sequence)
    try:
        yield
    finally:
        PoaGraph.from_sequence = orig


def deletion_read(read: bytes, at: int, d: int, seed: int) -> bytes:
    """``read`` with ~10% of its bases substituted and the ``d`` bases
    before position ``at`` deleted: against a graph whose node ``at`` has
    a staircase, its walk enters that node from the pred at table index
    ``d``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s = np.frombuffer(read, np.uint8).copy()
    s[rng.integers(0, len(s), len(s) // 10)] = rng.choice(acgt, len(s) // 10)
    return np.concatenate([s[:at - d], s[at:]]).tobytes()


@contextlib.contextmanager
def counting_plain():
    """Within: every call of the MSA round's plain versions
    (``round_dp_plain``, ``walk_plain``, ``walk_bounded_plain``) counted
    in the yielded dict."""
    from tsta_tpu_torch.ops import msa_native, msa_poa
    calls = {"round_dp_plain": 0, "walk_plain": 0, "walk_bounded_plain": 0}
    saved = [(m, name, getattr(m, name)) for m, name in (
        (msa_native, "round_dp_plain"), (msa_poa, "walk_plain"),
        (msa_poa, "walk_bounded_plain"))]

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for m, name, fn in saved:
        setattr(m, name, counted(name, fn))
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def deletion_reads(length=2000, cut=300):
    """Four seeded reads of ``length`` bp (``long_reads``' mutation at
    12%), then two that lack ``cut`` bp of the middle: the first makes an
    edge that skips the deleted rows, the second's walk takes it, a
    pred jump past the walk's window."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    reads = [base.tobytes()]
    for _ in range(3):
        s = base.copy()
        s[rng.integers(0, length, length // 8)] = rng.choice(acgt,
                                                             length // 8)
        reads.append(np.delete(s, rng.integers(0, length, length // 64))
                     .tobytes())
    mid = length // 3
    return reads + [reads[k][:mid + 5 * k] + reads[k][mid + 5 * k + cut:]
                    for k in (1, 2)]


def poa_wide_check(params, dev) -> dict:
    """``poa_dp.cu`` past the card's co-resident blocks: a 1.1 Mbp read
    against a graph grown from two 300 bp reads, planned at S = 32 into
    more shards than blocks, so blocks walk two shards each.  The single
    call (words, scores) and the round as one forward chunk from a zero
    ring (scores, ring, checkpoints at 4 windows) against the plain
    version on the card; returns the plan, the grid, the single call's
    time and its plain version's (CUDA events) and the largest
    difference."""
    import numpy as np
    import torch

    from tsta_tpu_torch.ops import _kernels, msa_native, msa_poa
    rng = np.random.default_rng(SEED + 3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 300)
    s = base.copy()
    s[rng.integers(0, 300, 36)] = rng.choice(acgt, 36)
    reads = [base.tobytes(), np.delete(s, rng.integers(0, 300, 5)).tobytes(),
             rng.choice(acgt, POA_WIDE_READ).tobytes()]
    r = next_round(reads, 1, params, dev)
    args = (*r["tables"], r["n_real"], r["n_nodes"], params, r["W"])
    n, nn, W = r["tables"][4].shape[0], r["n_nodes"], r["W"]
    D, C, S, T = msa_poa.poa_plan(n)
    G = max(1, min(D, _kernels.poa_dp_max_blocks(T, S, dev)))
    if G >= D:
        raise AssertionError("wide round: %d shards fit %d blocks" % (D, G))
    ms, (kw, ks) = cuda_ms(lambda: msa_poa.poa_dp(*args), 3)
    pms, (pw, ps) = cuda_ms(lambda: msa_native.round_dp_plain(*args), 1,
                            False)
    err = max(max_err(kw[:nn], pw[:nn]), max_err(ks, ps))
    del kw, pw
    N = r["tables"][0].shape[1]
    rings = [msa_poa.new_ring(W, n, dev) for _ in range(2)]
    ckpts = [torch.zeros((N, 4, 3), dtype=torch.int32, device=dev)
             for _ in range(2)]
    _, ks = msa_poa.poa_dp(*args, ring=rings[0], ckpt=ckpts[0],
                           with_words=False)
    _, ps = msa_native.round_dp_plain(*args, ring=rings[1], ckpt=ckpts[1],
                                      with_words=False)
    err = max(err, max_err(ks, ps), max_err(*rings), max_err(*ckpts))
    return {"shape": r["shape"], "plan": [D, C, S, T], "blocks": G,
            "ms": ms, "plain_ms": pms,
            "multi_pred_nodes": int((r["tables"][1].sum(0) > 1).sum()),
            "max_abs_err": err}


def plan_sweep(run, n, check):
    """The S x T sweep of ``poa_dp.cu``'s plan at an n-column launch:
    ``run(D, T)`` launches at D shards (C = 256 S columns) and T nodes a
    packet and returns its outputs, each held by ``check`` to the plan's
    run (largest difference).  Returns one record per (S, T): D, C, S, T,
    median ms of 3 launches and the error."""
    from tsta_tpu_torch.ops import msa_poa
    out = []
    for S in POA_S_SWEEP:
        D = -(-n // (256 * S))
        for T in POA_T_SWEEP:
            ms, got = cuda_ms(lambda: run(D, T), 3)
            out.append({"plan": list(msa_poa.poa_plan(n, D, T)), "ms": ms,
                        "max_abs_err": check(got)})
            del got
    return out


def relaid(ring, n, D_from, D_to):
    """A ring of an n-column launch laid out for D_from shards, laid out
    for D_to (None: the plan's)."""
    import torch

    from tsta_tpu_torch.ops import msa_poa
    dev = ring.device
    out = torch.zeros((ring.shape[0], 2, msa_poa.ring_width(n, D_to)),
                      dtype=ring.dtype, device=dev)
    out[:, :, msa_poa.ring_positions(n, dev, D_to)] = \
        ring[:, :, msa_poa.ring_positions(n, dev, D_from)]
    return out


def msa_phases(dev, smi_line):
    """Phases 7-11 (the native MSA engine); returns the MSA main path's
    launch counts and the POA kernels' timing records."""
    import numpy as np
    import torch

    from tsta_tpu_torch import AlignParams, cli
    from tsta_tpu_torch.native import build
    from tsta_tpu_torch.ops import _kernels, msa_native, msa_poa
    params = AlignParams()
    ex = example_msa_reads()

    # 7. each POA kernel against its plain version on grown graphs, the
    # walk also at forced plans (R = 0 among them) and on a round whose
    # walk takes a pred jump past its window
    errs = {"poa_dp": 0, "poa_walk": 0}
    shapes, walks = [], []
    sets = [grown_reads(1), grown_reads(2), deletion_reads()]
    for reads in sets:
        for rounds in range(len(reads) - 1):
            r = next_round(reads, rounds, params, dev)
            dp, walk = poa_compare(r, params, 1, False, POA_FORCED,
                                   POA_WALK_FORCED)
            errs["poa_dp"] = max(errs["poa_dp"], dp["max_abs_err"])
            errs["poa_walk"] = max(errs["poa_walk"], walk["max_abs_err"])
            shapes.append(r["shape"])
            walks.append({k: walk[k] for k in ("maxdist", "plan", "counts",
                                               "forced")})
    jump = walks[-1]
    wide = poa_wide_check(params, dev)
    errs["poa_dp"] = max(errs["poa_dp"], wide["max_abs_err"])
    emit({"phase": "poa_kernels", "max_abs_err": errs, "rounds": shapes,
          "plan": dp["plan"], "forced": dp["forced"], "walks": walks,
          "wide": wide})
    if any(errs.values()):
        raise AssertionError("POA kernel differs from its plain version: %s"
                             % errs)
    if jump["maxdist"] < 300 or not jump["counts"]["misses"]:
        raise AssertionError("the long-deletion round's walk took no jump "
                             "past its window: %s" % jump)

    # 8. the MSA main path through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "seq.fa")
        with open(fa, "wb") as f:
            f.write(b"".join(b">%d\n%s\n" % (k + 1, s)
                             for k, s in enumerate(ex)))
        out = os.path.join(tmp, "msa.out")
        # the metric is a warm process's: gcc builds the native FASTA
        # reader on its first use, which no earlier phase makes
        build.load_seqio()
        buf = io.StringIO()
        _kernels.reset_launches()
        p0 = msa_native.plain_rounds
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["msa", "-i", fa, "--engine", "native",
                           "--device", "cuda", "-o", out, "--json"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        plain = msa_native.plain_rounds - p0
        with open(out, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        # the compat engine (the port's own build of compat_msa.c, with
        # OpenMP only where gcc has it) gives the reference's output
        out_c = os.path.join(tmp, "compat.out")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc_c = cli.main(["msa", "-i", fa, "-o", out_c])
        compat_wall = time.perf_counter() - t0
        with open(out_c, "rb") as f, \
                open(os.path.join(GOLDEN, "msa_default.out"), "rb") as g:
            compat_ok = rc_c == 0 and f.read() == g.read()
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = {k: rec[k] for k in EXAMPLE_MSA}
    # the same reads through the library, for each round's wall split
    clock = msa_poa.RoundClock(dev)
    again = msa_native.align_seqs(ex, params, device=dev, clock=clock)
    emit({"phase": "msa_main_path", "rc": rc, "wall_s": wall,
          "cli_wall_s": rec["wall_s"], "launches": launches,
          "plain_rounds": plain, "sha256": sha, **got,
          "rounds_split": clock.rounds,
          "compat_golden_identical": compat_ok,
          "compat_wall_s": compat_wall,
          "compat_openmp": build.has_openmp(build.compiler())})
    if not compat_ok:
        raise AssertionError("compat engine differs from msa_default.out")
    n_rounds = len(EXAMPLE_MSA["rounds"])
    if again.round_scores != EXAMPLE_MSA["rounds"]:
        raise AssertionError("library run differs from the CLI run")
    if rc != 0 or got != EXAMPLE_MSA or sha != EXAMPLE_MSA_SHA256:
        raise AssertionError("MSA example differs from the JAX native "
                             "engine's result")
    if (launches["poa_dp"], launches["poa_walk"], plain) != (n_rounds,
                                                              n_rounds, 0):
        raise AssertionError("MSA main path did not run one DP and one walk "
                             "per round: %s, plain rounds %d"
                             % (launches, plain))

    # 9. 3 x 50 kbp, kernels and plain versions on the card
    seqs = long_reads()
    runs = {}
    for kernel in ("cuda", "plain"):
        clock = msa_poa.RoundClock(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_launches()
        p0 = msa_native.plain_rounds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = msa_native.align_seqs(seqs, params, kernel=kernel, device=dev,
                                    clock=clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[kernel] = {
            "out": res, "wall_s": wall,
            "cells_per_s": msa_cells(seqs, res) / wall,
            "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": {k: _kernels.launches[k]
                         for k in ("poa_dp", "poa_walk")},
            "plain_rounds": msa_native.plain_rounds - p0,
            "rounds_split": clock.rounds}
    res_50k = runs["cuda"].pop("out")
    same = res_50k == runs["plain"].pop("out")
    emit({"phase": "msa_50k", "equal": same, "rounds": res.round_scores,
          "graph_len": res.graph_len, "cells": msa_cells(seqs, res),
          "read_lengths": [len(x) for x in seqs], **runs, "smi": smi_line})
    if not same or runs["cuda"]["launches"] != {"poa_dp": 2, "poa_walk": 2} \
            or runs["plain"]["launches"] != {"poa_dp": 0, "poa_walk": 0} \
            or runs["cuda"]["plain_rounds"] or runs["plain"]["plain_rounds"]:
        raise AssertionError("3 x 50 kbp: kernel and plain routes differ")

    # 10. the fleet
    problems = [fleet_problem(100 + i) for i in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [msa_native.align_seqs(pr, params, device=dev)
               for pr in problems]
    t_seq = time.perf_counter() - t0
    _kernels.reset_launches()
    t0 = time.perf_counter()
    outs = msa_native.align_seqs_many(problems, params, device=dev)
    torch.cuda.synchronize()
    t_fleet = time.perf_counter() - t0
    fleet_launches = {k: _kernels.launches[k] for k in ("poa_dp", "poa_walk")}
    # a second call: the first one pays the streams' first use
    t0 = time.perf_counter()
    again = msa_native.align_seqs_many(problems, params, device=dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    cells = sum(msa_cells(pr, o) for pr, o in zip(problems, outs))
    emit({"phase": "msa_fleet", "problems": len(problems),
          "equal_to_single_runs": outs == singles == again,
          "wall_s": t_fleet, "problems_per_s": len(problems) / t_fleet,
          "cells_per_s": cells / t_fleet, "sequential_wall_s": t_seq,
          "warm_wall_s": t_warm,
          "warm_problems_per_s": len(problems) / t_warm,
          "launches": fleet_launches})
    if not outs == singles == again or fleet_launches["poa_dp"] != 24:
        raise AssertionError("fleet differs from per-problem runs")

    # 11. POA kernels and plain versions at the main path's shapes
    times, rounds_in = {}, {}
    for label, rseqs, rounds, warm in (("50 kbp round 2", seqs, 1, False),
                                       ("example round 4", ex, 3, True)):
        rounds_in[label] = r = next_round(rseqs, rounds, params, dev)
        dp, walk = poa_compare(r, params, 3, warm)
        times["poa_dp " + label] = dp
        times["poa_walk " + label] = walk
    # the plan's S x T sweep at the 50 kbp round 2
    r = rounds_in.pop("50 kbp round 2")
    args = (*r["tables"], r["n_real"], r["n_nodes"], params, r["W"])
    nn = r["n_nodes"]
    want = msa_poa.poa_dp(*args)
    sweep = plan_sweep(
        lambda D, T: msa_poa.poa_dp(*args, D=D, T=T), args[4].shape[0],
        lambda got: max(max_err(got[0][:nn], want[0][:nn]),
                        max_err(got[1], want[1])))
    times["poa_dp 50 kbp round 2"]["sweep"] = sweep
    del r, args, want, rounds_in
    emit({"phase": "poa_timings", "times": times, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    bad = {k: t["max_abs_err"] for k, t in times.items() if t["max_abs_err"]}
    bad.update({"sweep %s" % x["plan"]: x["max_abs_err"] for x in sweep
                if x["max_abs_err"]})
    if bad:
        raise AssertionError("POA kernel differs from its plain version at "
                             "the main path's shapes: %s" % bad)
    return launches, times, res_50k


def degapped_ok(seqs, out) -> bool:
    """Each MSA row without its gaps is its read, and the consensus is
    not empty."""
    return (len(out.rows) == len(seqs) and len(out.consensus) > 0
            and all(r.replace(b"-", b"") == bytes(s)
                    for r, s in zip(out.rows, seqs)))


def chunk_ops(tables, n_nodes, n, words):
    """Integer operations of one POA DP launch over ``n`` columns."""
    preds_in = int(tables[1][:, :n_nodes].sum())
    return n * (OPS_POA_PRED * preds_in + (OPS_POA_CELL + OPS_POA_WORD * words)
                * n_nodes)


def chunked_phases(dev, smi_line, res_50k):
    """Phases 12-14 (chunked rounds); returns the slice's launch counts
    from the 200 kbp run, the chunked kernels' timing records at its
    shapes and K1's score and corner of reads 0 and 1 with round 1's
    score."""
    import torch

    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.ops import _kernels, msa_native, msa_poa
    params = AlignParams()
    seqs = long_reads()
    budget_50k = BUDGET_50K

    # 12. a forward chunk of the 50 kbp round 2 (phase 13's path), kernel
    # against plain
    r = next_round(seqs, 1, params, dev, budget_50k)
    NC, NWIN, W = r["NC"], r["NWIN"], r["W"]
    predsT, pmaskT, bases, fills, a = r["tables"]
    n = a.shape[0]

    def chunk(c):
        sl = slice(c * NC, (c + 1) * NC)
        return [predsT[:, sl].contiguous(), pmaskT[:, sl].contiguous(),
                bases[sl], fills[:, sl].contiguous(), a]

    ring0 = msa_poa.new_ring(W, n, dev)
    ck0 = torch.zeros((NC, NWIN, 3), dtype=torch.int32, device=dev)
    msa_poa.poa_dp(*chunk(0), r["n_real"], NC, params, W, ring=ring0,
                   ckpt=ck0, with_words=False)
    outs = {}

    def forward(fn, key):
        ring = ring0.clone()
        ck = torch.zeros((NC, NWIN, 3), dtype=torch.int32, device=dev)
        _, sc = fn(*chunk(1), r["n_real"], NC, params, W, ring=ring,
                   chunk_base=NC, ckpt=ck, with_words=False)
        outs[key] = (sc, ring, ck)

    ms, _ = cuda_ms(lambda: forward(msa_poa.poa_dp, "kernel"), 3)
    pms, _ = cuda_ms(lambda: forward(msa_native.round_dp_plain, "plain"), 1,
                     False)
    err = max(max_err(k, p) for k, p in zip(outs["kernel"], outs["plain"]))
    tabs = chunk(1)
    emit({"phase": "chunk_kernels_50k",
          "shape": "50 kbp round 2, chunk 1: %d rows x %d columns, NWIN %d, "
                   "W %d" % (NC, n, NWIN, W),
          "ms": ms, "plain_ms": pms, "max_abs_err": err,
          **bound(nbytes(*tabs, *outs["kernel"]) + nbytes(ring0),
                  chunk_ops(tabs, NC, n, False)),
          "plan": {"NC": NC, "NWIN": NWIN, "n": n}})
    if err or not NWIN:
        raise AssertionError("forward chunk differs from its plain version")
    del outs, ring0, ck0, r

    # 13. 3 x 50 kbp cut into >= 4 chunks, against phase 9's unchunked run
    clock = msa_poa.RoundClock(dev)
    _kernels.reset_launches()
    p0 = msa_native.plain_rounds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = msa_native.align_seqs(seqs, params, device=dev, clock=clock,
                                budget=budget_50k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _kernels.launches[k] for k in ("poa_dp", *CHUNK_KERNELS)}
    plain = msa_native.plain_rounds - p0
    same = out == res_50k
    emit({"phase": "msa_50k_chunked", "equal_to_unchunked": same,
          "wall_s": wall, "cells_per_s": msa_cells(seqs, out) / wall,
          "rounds": out.round_scores, "launches": launches,
          "plain_rounds": plain, "rounds_split": clock.rounds})
    if not same or plain or launches["poa_dp"] \
            or min(launches[k] for k in CHUNK_KERNELS) < 1 \
            or min(rd.get("chunks", 0) for rd in clock.rounds) < 4:
        raise AssertionError("3 x 50 kbp chunked differs from unchunked")

    # 14. the slice at full width: 3 x 200 kbp at the card's budget
    seqs = long_reads(13, 200000)
    clock = msa_poa.RoundClock(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    p0 = msa_native.plain_rounds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = msa_native.align_seqs(seqs, params, device=dev, clock=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    plain = msa_native.plain_rounds - p0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    cells = msa_cells(seqs, out)
    ok = degapped_ok(seqs, out)
    emit({"phase": "msa_200k", "wall_s": wall, "cells": cells,
          "cells_per_s": cells / wall, "peak_device_gb": peak,
          "rounds": out.round_scores, "graph_len": out.graph_len,
          "add_len": out.add_len, "read_lengths": [len(x) for x in seqs],
          "launches": {k: launches[k] for k in ("poa_dp", "poa_walk",
                                                 *CHUNK_KERNELS)},
          "plain_rounds": plain, "rows_degapped_equal_reads": ok,
          "rounds_split": clock.rounds, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if not ok or plain or launches["poa_dp"] or launches["poa_walk"] \
            or min(launches[k] for k in CHUNK_KERNELS) < 1 \
            or not all("NC" in rd for rd in clock.rounds):
        raise AssertionError("3 x 200 kbp did not run every round chunked "
                             "through the kernels")
    times, k1 = check_200k(dev, smi_line, seqs, out)
    return {k: launches[k] for k in CHUNK_KERNELS}, times, k1


def pair_rows(out, i: int, k: int):
    """Rows ``i`` and ``k`` of an MSA without the columns where both are
    gaps: the pairwise alignment the MSA gives the two reads."""
    ri, rk = out.rows[i], out.rows[k]
    keep = [c for c in range(len(ri)) if ri[c] != 45 or rk[c] != 45]
    return bytes(ri[c] for c in keep), bytes(rk[c] for c in keep)


def hold_round(dev, g, seq, label: str, sweep: bool, budget=None):
    """One chunked round of ``seq`` against ``g`` at the card's budget
    (or ``budget``; ``label`` names it in the records' shapes), forward
    through the kernel, then held piece by piece to the plain
    versions: its last forward chunk from the ring that entered it
    (scores, ring out, checkpoints, each also against the forward's), and
    the first cell its walk rematerialises (words, ring out) and walks
    (exit state, align entries).  With ``sweep``, the S x T sweep of the
    forward chunk, every output equal to the plan's run.  Returns the
    timing records of the three chunked kernels, the forward's seconds
    and best-sink score and the walk's exit state."""
    import torch

    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.device import device_budget
    from tsta_tpu_torch.ops import msa_chunked, msa_native, msa_poa
    params = AlignParams()
    times = {}
    prep, n, n_real, a, NC, NWIN = msa_poa.prep_round(
        g, seq, params, budget or device_budget(dev))
    r = msa_chunked.ChunkedRound(g, prep, a, n_real, NC, NWIN, params, dev)
    rule = bound if r.lists is None else poa_wide_bound
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps, scores, ckpt = r.forward(msa_poa.poa_dp)
    best = int(msa_poa.best_sink(scores, r.mask))
    forward_s = time.perf_counter() - t0
    forward_score = int(scores[best])

    # the last forward chunk from the ring that entered it
    c = r.nchunks - 1
    sl = slice(c * NC, (c + 1) * NC)
    outs = {}

    def forward(fn, key, D=None, T=None):
        ring = relaid(snaps[c], n, None, D)
        ck = torch.zeros((NC, NWIN, 3), dtype=torch.int32, device=dev)
        args, kw = r.forward_call(c, ring, ck)
        if D or T:
            kw.update(D=D, T=T)
        outs[key] = (fn(*args, **kw)[1], ring, ck)
        return D, outs[key]

    ms, _ = cuda_ms(lambda: forward(msa_poa.poa_dp, "kernel"), 3)
    pms, _ = cuda_ms(lambda: forward(msa_native.round_dp_plain, "plain"), 1,
                     False)
    ksc, _, kck = outs["kernel"]
    err = max(*(max_err(k, p) for k, p in zip(outs["kernel"], outs["plain"])),
              max_err(ksc, scores[sl]), max_err(kck, ckpt[sl]))
    args, _ = r.forward_call(c, None, None)
    times["poa_dp_chunk"] = {
        "shape": "%s, chunk %d: %d of %d rows x %d columns, "
                 "NWIN %d, W %d" % (label, c, r.rows(c), NC, n, NWIN, r.W),
        "ms": ms, "plain_ms": pms, "max_abs_err": err,
        "plan": list(msa_poa.poa_plan(n)),
        **rule(nbytes(*args[:5], snaps[c], *outs["kernel"]),
               chunk_ops(args[:2], r.rows(c), n, False))}
    if sweep:
        want = outs["kernel"]

        def check(got):
            D, (sc, ring, ck) = got
            return max(max_err(sc, want[0]), max_err(ck, want[2]),
                       max_err(relaid(ring, n, D, None), want[1]))

        times["poa_dp_chunk"]["sweep"] = plan_sweep(
            lambda D, T: forward(msa_poa.poa_dp, "sweep", D, T), n, check)
    del outs

    # the first cell the walk rematerialises, and its walk
    hb = ckpt[:, :, 0].contiguous()
    row, j = best, n_real - 1
    c, w = r.cell(row, j)
    args, kw = r.remat_call(c, w, snaps[c], ckpt, hb)
    ring_in = kw.pop("ring")
    res = {}

    def remat(fn, key):
        ring = ring_in.clone()
        words, _ = fn(*args, ring=ring, **kw)
        res[key] = (words, ring)

    ms, _ = cuda_ms(lambda: remat(msa_poa.poa_dp, "kernel"), 3)
    pms, _ = cuda_ms(lambda: remat(msa_native.round_dp_plain, "plain"), 1,
                     False)
    words = res["kernel"][0]
    err = max(max_err(k, p) for k, p in zip(res["kernel"], res["plain"]))
    times["poa_dp_window"] = {
        "shape": "%s, cell (%d, %d): %d of %d rows x %d columns"
                 % (label, c, w, r.rows(c), NC, r.CW),
        "ms": ms, "plain_ms": pms, "max_abs_err": err,
        "plan": list(msa_poa.poa_plan(r.CW)),
        **rule(nbytes(*[x for x in args if torch.is_tensor(x)], ring_in,
                      *res["kernel"]),
               chunk_ops(args[:2], r.rows(c), r.CW, True))}
    preds = r.chunk_preds(c)
    walks = {}
    counts = torch.zeros((4,), dtype=torch.int32, device=dev)

    def walk(fn, key, **kw):
        align = torch.full((n,), -1, dtype=torch.int32, device=dev)
        walks[key] = (fn(words, preds, row, j, 0, c * NC, w * r.CW, align,
                         **kw), align)

    wms, _ = cuda_ms(lambda: walk(msa_poa.poa_walk_bounded, "kernel",
                                  maxdist=r.maxdist, counts=counts), 3)
    wpms, _ = cuda_ms(lambda: walk(msa_poa.walk_bounded_plain, "plain"), 1,
                      False)
    consumed = j - int(walks["kernel"][0][1])
    werr = max(max_err(k, p) for k, p in zip(walks["kernel"], walks["plain"]))
    if r.lists is None:
        rec = poa_walk_record(counts.tolist(), r.maxdist, preds.shape[1])
    else:
        rec = wide_walk_record(counts.tolist(), words, preds, row, j,
                               r.maxdist, c * NC, w * r.CW)
    mv = rec["counts"]
    times["poa_walk_bounded"] = {
        "shape": times["poa_dp_window"]["shape"] + ", %d columns walked"
                 % consumed,
        "ms": wms, "plain_ms": wpms, "max_abs_err": werr,
        "consumed": consumed, "maxdist": r.maxdist, **rec,
        # a word a move, a pred a pred move, an align write a column
        **rule(mv["moves"] * words.element_size() + mv["pred_moves"] * 4
               + consumed * 4 + 12, OPS_WALK_STEP * mv["moves"])}
    return times, forward_s, forward_score, walks["kernel"][0].tolist()


def check_200k(dev, smi_line, seqs, out):
    """Phase 12 at 200 kbp and the checks of phase 14's result, after its
    timed run.  Rounds 1 and 2 of ``seqs`` run forward again through the
    kernel (round 2 on the graph that round 1 through the kernels and
    the merge gives), each held to the plain versions by
    :func:`hold_round`, round 1 with the plan's S x T sweep; round 2's
    forward score must equal phase 14's.  Round 1 aligns read 1 to read
    0's chain, a global pairwise alignment, so its score must equal the
    PSA DP's corner and the score of MSA rows 0 and 1; round 2's graph
    holds the paths of reads 0 and 1, so its score is at least either
    pairwise score of read 2.  Returns round 1's timing records of the
    three chunked kernels."""
    import numpy as np
    import torch

    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.device import device_budget
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_native, msa_poa, psa_diff
    from tsta_tpu_torch.ops import traceback as tb
    params = AlignParams()
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    times, forward_s, forward_score, exit_state = hold_round(
        dev, g, seqs[1], "200 kbp round 1", True)
    packed, order, _ = msa_poa.run_round(g, seqs[1], params, dev, "cuda",
                                         device_budget(dev))
    msa_native._finish_round(g, seqs[1], 1, order, packed.cpu().numpy(),
                             [], [], [])
    times2, forward2_s, forward2_score, exit2 = hold_round(
        dev, g, seqs[2], "200 kbp round 2", False)
    consumed = min(times["poa_walk_bounded"]["consumed"],
                   times2["poa_walk_bounded"]["consumed"])
    del g, packed

    # the round scores against the pairwise DP
    reads = [np.frombuffer(bytes(s), np.uint8) for s in seqs]
    pa, pb, lens = psa_diff.pack_pairs([(reads[1], reads[0]),
                                        (reads[2], reads[0]),
                                        (reads[2], reads[1])], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k1_scores, corners = (x.tolist()
                          for x in psa_diff.dp_packed(pa, pb, lens, params))
    pairwise_s = time.perf_counter() - t0
    rescored = tb.score_alignment(*pair_rows(out, 0, 1), params)
    scores_ok = (out.round_scores[0] == forward_score == corners[0]
                 == rescored and out.round_scores[1] >= max(corners[1:])
                 and out.round_scores[1] == forward2_score)
    emit({"phase": "check_200k", "rounds": out.round_scores,
          "round1_forward_s": forward_s, "round1_forward_score": forward_score,
          "round2_forward_s": forward2_s,
          "round2_forward_score": forward2_score,
          "pairwise_scores": k1_scores, "pairwise_corners": corners,
          "pairwise_s": pairwise_s,
          "rows01_rescored": rescored, "scores_ok": scores_ok,
          "times": times, "exit_state": exit_state, "round2_times": times2,
          "round2_exit_state": exit2, "smi": smi_line})
    bad = {"%s %s" % (rd, k): t["max_abs_err"]
           for rd, tt in (("round 1", times), ("round 2", times2))
           for k, t in tt.items() if t["max_abs_err"]}
    bad.update({"sweep %s" % x["plan"]: x["max_abs_err"]
                for x in times["poa_dp_chunk"]["sweep"] if x["max_abs_err"]})
    if bad or consumed < 1:
        raise AssertionError("200 kbp: kernel differs from its plain "
                             "version: %s" % bad)
    if not scores_ok:
        raise AssertionError("3 x 200 kbp round scores disagree with the "
                             "pairwise DP")
    # K1 of reads 1 and 0 (the DP is symmetric under swapping the two
    # sequences, so phase 15's pair, read 0 against read 1, has the same
    # score and corner)
    return times, {"score": k1_scores[0], "corner": corners[0],
                   "round1": out.round_scores[0], "s": pairwise_s}


def mutated_stretch(read: bytes, start: int, length: int, seed: int):
    """``length`` bases of ``read`` from ``start``, ~5% substituted and
    ~2% deleted (as ``long_reads`` mutates)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s = np.frombuffer(read[start:start + length], np.uint8).copy()
    hit = rng.random(len(s)) < 0.05
    s[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, hit.sum())]
    return np.delete(s, rng.integers(0, len(s), len(s) // 50))


def psa_chunked_phases(dev, smi_line, k1):
    """Phase 15, the chunked traced PSA: (a) the 10 kbp example through 20
    chunks, against the golden and the unchunked path; (b) every chunk of
    a 200,000-column pair at mc = 512, kernel against plain (DP from each
    chunk's snapshot, the walk of each chunk from its entry); (c) reads 0
    and 1 of the 3 x 200 kbp set through ``tsta-torch psa`` at the card's
    budget, the launch counters reset before and read after; (d) (c)'s
    chunk 0 again, kernel against plain at (c)'s shape.  ``k1``:
    K1's score and corner of those reads and MSA round 1's score.  Returns
    (c)'s launches and the timing records of the two kernels."""
    import numpy as np
    import torch

    from tsta_tpu_torch import AlignParams, cli
    from tsta_tpu_torch.io import encode_dna
    from tsta_tpu_torch.ops import _kernels, psa_chunked, psa_diff, psa_pallas
    from tsta_tpu_torch.ops import traceback as tb
    params = AlignParams()
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)

    # (a) the example pair through 20 chunks of 512 rows
    s1, s2 = golden_example()
    with open(os.path.join(GOLDEN, "psa_default.out"), "rb") as f:
        gold = f.read()
    ea, eb = encode_dna(s1), encode_dna(s2)
    t0 = time.perf_counter()
    got = psa_chunked.psa_align_traced_chunked(ea, eb, p, mc=512, device=dev)
    wall_a = time.perf_counter() - t0
    clock_a = psa_chunked.last_clock
    unchunked = psa_pallas.psa_align_traced_device(ea, eb, p, device=dev)
    example_ok = (b">1\n" + got[2].a_row + b"\n>2\n" + got[2].b_row == gold
                  and got == unchunked and got[0] == -5)
    emit({"phase": "psa_chunked_example", "chunks": clock_a.chunks,
          "remats": clock_a.remats, "walks": clock_a.walks,
          "golden_identical_and_equal_unchunked": example_ok,
          "score": got[0], "corner": got[1], "wall_s": wall_a})
    if not example_ok or clock_a.chunks != 20:
        raise AssertionError("10 kbp example through 20 chunks differs")

    # (b) 200,000 columns against a ~2 kbp stretch, every chunk and walk
    reads = long_reads(13, 200000)
    a = np.frombuffer(reads[0], np.uint8)
    b = mutated_stretch(reads[0], 100000, 2000, SEED)
    mc_b = 512
    pair = psa_chunked.ChunkedPair(a, b, p, mc_b, dev)
    snaps, last_rows, _, _, last_plane = pair.forward(psa_chunked.chunk_dp)
    del last_plane
    errs = {"psa_dp_chunk": 0, "psa_walk_bounded": 0}
    planes = []
    for c in range(pair.nchunks):
        args = pair.chunk_call(c, *snaps[c])
        kern = psa_chunked.chunk_dp(*args)
        plain = psa_chunked.chunk_dp_plain(*args)
        nxt = snaps[c + 1] if c + 1 < pair.nchunks else kern[3:]
        errs["psa_dp_chunk"] = max(
            errs["psa_dp_chunk"],
            *(max_err(k, w) for k, w in zip(kern, plain)),
            *(max_err(k, w) for k, w in zip(kern[3:], nxt)))
        planes.append(kern[2])
        del plain
    L = pair.m_pad + pair.n_pad
    moves_k = torch.zeros(L, dtype=torch.int8, device=dev)
    moves_p = torch.zeros(L, dtype=torch.int8)
    state = (pair.m_real - 1, pair.n_real - 1, 0, 0)
    walks = []
    while True:
        c = state[0] // pair.mc
        wargs = pair.walk_call(c, planes[c], last_rows, *state, moves_k)
        t0 = time.perf_counter()
        kst = tb.walk_bounded(*wargs).tolist()
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pst = tb.walk_bounded_plain(*wargs[:-1], moves_p).tolist()
        p_s = time.perf_counter() - t0
        seg = slice(state[2], kst[2])
        err = max(max_err(torch.tensor(kst), torch.tensor(pst)),
                  max_err(moves_k[seg].cpu(), moves_p[seg]))
        errs["psa_walk_bounded"] = max(errs["psa_walk_bounded"], err)
        walks.append({"chunk": c, "steps": kst[2] - state[2],
                      "host_s": k_s, "plain_s": p_s})
        state = tuple(kst)
        if state[0] < 0:
            break
    aln = tb.emit_alignment(moves_k[:state[2]].cpu().numpy(), a, b,
                            pair.n_real, pair.m_real)
    rescored = tb.score_alignment(aln.a_row, aln.b_row, params)
    corner_b = int(psa_diff.dp_packed(*psa_diff.pack_pairs([(a, b)], dev),
                                      p)[1][0])
    wargs = None
    emit({"phase": "psa_chunked_full_width", "shape": [pair.m_pad, pair.n_pad],
          "mc": pair.mc, "chunks": pair.nchunks, "max_abs_err": errs,
          "walks": walks, "rescored": rescored, "k1_corner": corner_b})
    if any(errs.values()) or rescored != corner_b or len(walks) < pair.nchunks:
        raise AssertionError("chunked kernels differ from their plain "
                             "versions at full width: %s" % errs)
    del planes, snaps, moves_k, moves_p, pair

    # (c) the slice at full width through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "r0.fa"), os.path.join(tmp, "r1.fa")
        with open(fa, "wb") as f:
            f.write(b">r0\n" + reads[0] + b"\n")
        with open(fb, "wb") as f:
            f.write(b">r1\n" + reads[1] + b"\n")
        out = os.path.join(tmp, "out.txt")
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["psa", "-1", fa, "-2", fb, "-o", out,
                           "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        with open(out, "rb") as f:
            lines = f.read().split(b"\n")
        run = psa_chunked.last_clock.record()
        # (e) the same pair score-only: TSTA_psa_notrace's route
        notrace = notrace_cli(fa, fb, reads[:2])
    a_row, b_row = lines[1], lines[3]
    rescored = tb.score_alignment(a_row, b_row, params)
    degapped = (a_row.replace(b"-", b"") == reads[0]
                and b_row.replace(b"-", b"") == reads[1])
    cells = len(reads[0]) * len(reads[1])
    stdout = buf.getvalue().split()
    emit({"phase": "psa_chunked_200k", "rc": rc, "stdout": stdout,
          "wall_s": wall, "gcups": cells / wall / 1e9, "cells": cells,
          "peak_device_gb": peak, "launches": {
              k: launches[k] for k in ("psa_dp_chunk", "psa_walk_bounded",
                                       "psa_dp_traced", "psa_walk")},
          "k1": k1, "rescored": rescored, "walk_S": _kernels.WALK_S,
          "rows_degapped_equal_reads": degapped,
          "lengths": [len(reads[0]), len(reads[1])], **run, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if rc != 0 or stdout != ["maxsorce=%d" % k1["score"]]:
        raise AssertionError("200 kbp pair: stdout %s, K1 score %d"
                             % (stdout, k1["score"]))
    if not (run["score"] == k1["score"] and run["corner"] == k1["corner"]
            == k1["round1"] == rescored) or not degapped:
        raise AssertionError("200 kbp pair: score/corner/rows disagree with "
                             "K1 and MSA round 1")
    if (launches["psa_dp_chunk"] < run["chunks"] + run["remats"]
            or launches["psa_walk_bounded"] < run["walks"]
            or run["walks"] < run["chunks"]
            or launches["psa_dp_traced"] or launches["psa_walk"]):
        raise AssertionError("200 kbp pair did not run on the chunked "
                             "kernels alone: %s %s" % (launches, run))
    n_pad_200k = -(-len(reads[0]) // psa_diff.LANES) * psa_diff.LANES
    notrace["plan"] = dict(zip("DCWT", psa_diff.score_plan(
        1, n_pad_200k, torch.cuda.get_device_properties(
            dev).multi_processor_count)))
    notrace["gcups"] = cells / notrace["wall_s"] / 1e9
    emit({"phase": "psa_notrace_200k", **notrace,
          "traced": [run["score"], run["corner"]], "smi": smi_line})
    if (not notrace["one_k1_launch"] or notrace["plan"]["D"] < 2
            or not [notrace["score"], notrace["corner"]]
            == [run["score"], run["corner"]] == notrace["plain"]):
        raise AssertionError("200 kbp pair, --notrace: %s against the "
                             "traced route's %s" % (notrace, run))

    # (d) (c)'s chunk 0 at (c)'s shape, after the timed run: its DP from
    # the entry frontier, and its walk from the state (c)'s walk entered
    # it with, each kernel against plain, every output exactly
    n_pad, mc = run["n_pad"], run["mc"]
    pair = psa_chunked.ChunkedPair(encode_dna(reads[0]), encode_dna(reads[1]),
                                   p, mc, dev)
    args = pair.chunk_call(0, *pair.entry())
    outs = {}
    dk_ms, _ = cuda_ms(lambda: outs.update(kernel=psa_chunked.chunk_dp(*args)),
                       1, False)
    dp_plain_ms, _ = cuda_ms(
        lambda: outs.update(plain=psa_chunked.chunk_dp_plain(*args)), 1, False)
    err_dp = max(max_err(k, w) for k, w in zip(outs["kernel"], outs["plain"]))
    del outs["plain"]
    # the kernel's plan for this width, and the T sweep: the same chunk at
    # each packet height, every output equal to the plan's run
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = psa_chunked.chunk_plan(n_pad, sms)
    got = [torch.empty_like(x) for x in outs["kernel"]]
    sweep, sweep_equal = {}, True
    for T in CHUNK_T_SWEEP:
        sweep[T], _ = cuda_ms(lambda: _kernels.psa_dp_chunk(
            *args[:4], args[6], args[4], args[5], got[3], got[4], got[0],
            got[1], got[2], T=T), 1, False)
        sweep_equal &= all(torch.equal(g, k)
                           for g, k in zip(got, outs["kernel"]))
    del got
    emit({"phase": "psa_chunk_plan", "shape": [mc, n_pad], "sms": sms,
          "plan": dict(zip("DCWT", plan)),
          "ms_over_pr10": statistics.median(run["dp_ms"]) / PR10_CHUNK_MS,
          "layout_equals_plan": _kernels.psa_dp_chunk_layout(n_pad, sms)
          == plan, "t_sweep_ms": sweep, "t_sweep_equal": sweep_equal,
          "fill_rows": (plan[0] - 1) * plan[3]})
    if not sweep_equal or _kernels.psa_dp_chunk_layout(n_pad, sms) != plan:
        raise AssertionError("chunk DP: the T sweep's outputs differ, or the "
                             "kernel's plan is not chunk_plan's")
    plane = outs["kernel"][2]
    del outs
    state = tuple(run["walk_from"][-1])
    L = pair.m_pad + pair.n_pad
    moves_k = torch.zeros(L, dtype=torch.int8, device=dev)
    moves_p = torch.zeros(L, dtype=torch.int8)
    wargs = pair.walk_call(0, plane, [], *state, moves_k)
    wk_ms, kst = cuda_ms(lambda: tb.walk_bounded(*wargs).tolist(), 1, False)
    t0 = time.perf_counter()
    pst = tb.walk_bounded_plain(*wargs[:-1], moves_p).tolist()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    seg = slice(state[2], kst[2])
    err_walk = max(max_err(torch.tensor(kst), torch.tensor(pst)),
                   max_err(moves_k[seg].cpu(), moves_p[seg]))
    steps = kst[2] - state[2]
    walk_sweep = {}   # Q2-8's phase length, every output equal
    for S in WALK_S_SWEEP:
        moves_k.zero_()
        walk_sweep[S], sst = cuda_ms(
            lambda: tb.walk_bounded(*wargs, S=S).tolist(), 3)
        err_walk = max(err_walk, max_err(torch.tensor(sst), torch.tensor(pst)),
                       max_err(moves_k[seg].cpu(), moves_p[seg]))
    del wargs, plane, moves_k, moves_p, pair
    emit({"phase": "psa_chunked_200k_chunk0", "shape": [mc, n_pad],
          "max_abs_err": {"psa_dp_chunk": err_dp,
                          "psa_walk_bounded": err_walk},
          "chunk_dp_ms": dk_ms, "chunk_dp_plain_ms": dp_plain_ms,
          "walk_from": state, "walk_exit": kst, "walk_steps": steps,
          "walk_ms": wk_ms, "walk_plain_host_ms": walk_plain_ms,
          "walk_S": _kernels.WALK_S, "walk_s_sweep_ms": walk_sweep})
    if (err_dp or err_walk or state[0] != mc - 1 or kst[:2] != [-1, -1]
            or steps != run["walk_steps"][-1]):
        raise AssertionError("200 kbp chunk 0: kernel differs from its "
                             "plain version: dp %d, walk %d, from %s to %s"
                             % (err_dp, err_walk, state, kst))

    times = {
        "traced_200k": {"score": run["score"], "corner": run["corner"]},
        "psa_dp_chunk": {
            "shape": "ms: (c) median of %d launches, %d x %d rows x columns "
                     "(D %d, C %d, W %d, T %d); plain_ms: (d) chunk 0 of (c), "
                     "the same shape; max_abs_err: (d) and every chunk of "
                     "(b), %d x %d"
                     % (len(run["dp_ms"]), mc, n_pad, *plan, mc_b, n_pad),
            "ms": statistics.median(run["dp_ms"]), "plain_ms": dp_plain_ms,
            "max_abs_err": max(errs["psa_dp_chunk"], err_dp),
            # a, the chunk's b, lens, h/e in and out, best, corner, plane
            **bound(n_pad + mc + 8 + 16 * n_pad + 8 + mc * n_pad,
                    (OPS_PSA_CELL + OPS_PSA_CODE) * mc * n_pad)},
        "psa_walk_bounded": {
            "shape": "ms: (c) its walk of chunk 0, %d steps in a %d x %d "
                     "plane; plain_ms: (d) the same walk (host clock); "
                     "max_abs_err: (d) and every walk of (b)"
                     % (steps, mc, n_pad),
            "ms": run["walk_ms"][-1], "plain_ms": walk_plain_ms,
            "max_abs_err": max(errs["psa_walk_bounded"], err_walk),
            "S": _kernels.WALK_S, "s_sweep_ms": walk_sweep,
            **chain_bound(steps),
            # per step one plane byte read and one move byte written
            **bound(2 * steps + 16, OPS_WALK_STEP * steps)}}
    return {k: launches[k] for k in ("psa_dp_chunk", "psa_walk_bounded")}, \
        times


def k3_plan(P: int) -> list:
    """K3's plan (S, threads) for a launch of P pairs on card 0."""
    import torch

    from tsta_tpu_torch.ops import _kernels
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return list(_kernels.psa_walk_layout(P, sms))


def traced_batch_walks(dev, smi_line, params, p) -> dict:
    """Phase 6 (b): K3 on a traced batch of more pairs than SMs, where its
    plan takes a smaller S.
    ``align_batch_traced_device`` on phase 16 (c)'s 4,096 pairs of
    150-2,000 bp under the default scoring, the launch counters reset
    before and read after: one traced DP and one K3 launch a group of the
    route (``psa_diff._traced_groups``), no plain call, every score and
    corner equal to K1's on the same pairs.  Then each group's plane walked
    by K3 at its plan and by the plain walk, every word and count equal;
    K3's ms are its launches' sum over the groups (CUDA events, after its
    DP, as on the route)."""
    import numpy as np
    import torch

    from tsta_tpu_torch.device import device_budget
    from tsta_tpu_torch.ops import psa_diff
    from tsta_tpu_torch.ops import traceback as tb
    from tsta_tpu_torch.parallel import batch as pbatch
    pairs = pbatch._prep(short_pairs(np.random.default_rng(SEED + 16), 4096),
                         True)
    groups, chunked = psa_diff._traced_groups(
        *psa_diff._lengths(pairs), device_budget(dev))
    p0 = start()
    t0 = time.perf_counter()
    res = pbatch.align_batch_traced_device(pairs, params, swap=False,
                                           device=dev)
    wall = time.perf_counter() - t0
    lr, plain = stop(p0)
    a, b, lens = psa_diff.pack_pairs(pairs, dev)
    ks, kc = (x.cpu().tolist() for x in psa_diff.dp_packed(a, b, lens, p))
    scores_equal = [(r[0], r[1]) for r in res] == list(zip(ks, kc))
    del a, b, lens
    ms = pms = 0.0
    err = steps = longest = moved = 0
    plans, plain_walks = [], []
    for g in groups:
        a, b, nm = psa_diff.pack_pairs([pairs[i] for i in g], dev, traced=True)
        plane = psa_diff.dp_packed(a, b, nm, p, True)[2]
        del a, b
        gms, (kw, kcnt) = cuda_ms(lambda: tb.walk_packed(plane, nm), 3)
        gpms, (pw, pcnt) = cuda_ms(lambda: tb.walk_packed_plain(plane, nm),
                                   1, False)
        ms, pms = ms + gms, pms + gpms
        err = max(err, max_err(kw, pw), max_err(kcnt, pcnt))
        steps += int(kcnt.sum())
        moved += int(kcnt.sum()) + nbytes(nm, kw, kcnt)
        longest = max(longest, int(kcnt.max()))
        plans.append([len(g), *plane.shape[1:], *k3_plan(len(g))])
        plain_walks.append((pw, pcnt))
        del plane, nm, kw, kcnt, pw, pcnt
    rec = {"shape": "%d pairs of 150-2,000 bp traced, %d groups" % (
               len(pairs), len(groups)),
           "ms": ms, "plain_ms": pms, "max_abs_err": err,
           "groups": plans, "steps": steps, "route_wall_s": wall,
           **chain_bound(longest),
           **bound(moved, OPS_WALK_STEP * steps)}
    emit({"phase": "traced_batch_walks", "launches": lr,
          "plain_calls": plain, "scores_equal_k1": scores_equal,
          "times": rec, "smi": smi_line})
    if (chunked or plain or not scores_equal
            or lr["psa_walk"] != len(groups)
            or lr["psa_dp_traced"] != len(groups)
            or min(g[-2] for g in plans) == k3_plan(1)[0]):
        raise AssertionError("traced batch of short pairs: wrong result, "
                             "route or plan: %s %s plain %d, scores equal "
                             "%s" % (lr, plans, plain, scores_equal))
    return rec, {"pairs": pairs, "groups": groups, "plain": plain_walks,
                 "plain_ms": pms}


def short_pairs(rng, count):
    """``count`` seeded pairs of 150-2,000 bp, b a copy of a with ~5%
    substituted, ~2.5% deleted and ~2.5% inserted (~10% edits)."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(count):
        n = int(rng.integers(150, 2001))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        b[rng.integers(0, n, n // 20)] = rng.integers(0, 4, n // 20)
        b = np.delete(b, rng.integers(0, n, n // 40))
        b = np.insert(b, rng.integers(0, len(b), n // 40),
                      rng.integers(0, 4, n // 40).astype(np.uint8))
        pairs.append((acgt[a], acgt[b]))
    return pairs


def edit_phases(dev, smi_line, batch_pairs):
    """Phase 16, edit scoring on the round-1 kernels: (a) the 10 kbp
    example through ``tsta-torch psa``, then its DP and walk against their
    plain versions; (b) ``batch_pairs`` (phase 5's 128 x 10,240 bp)
    through the score router to the batch kernel; (c) 4,096 short pairs
    to the short-pair kernel; (d) the 200 kbp pair through ``tsta-torch
    psa`` in chunks.  Each path runs with the launch counters and the
    count of plain calls on the card reset before it and read after it.
    Returns each path's launches under its kernels record's name and the
    four records' timings."""
    import numpy as np
    import torch

    from tsta_tpu_torch import AlignParams, cli
    from tsta_tpu_torch.io import encode_dna
    from tsta_tpu_torch.ops import _kernels, psa_chunked, psa_diff, psa_pallas
    from tsta_tpu_torch.ops import psa_scan
    from tsta_tpu_torch.ops import traceback as tb
    params = AlignParams(*EDIT)
    times, launches = {}, {}

    def start():
        torch.cuda.synchronize()
        _kernels.reset_launches()
        return psa_scan.plain_calls, time.perf_counter()

    def stop(p0):
        torch.cuda.synchronize()
        return dict(_kernels.launches), psa_scan.plain_calls - p0

    # (a) the example pair through the CLI, warm process
    s1, s2 = golden_example()
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "seqa1.fa"), os.path.join(tmp, "seqb1.fa")
        with open(fa, "wb") as f:
            f.write(b">seqa1\n" + s1 + b"\n")
        with open(fb, "wb") as f:
            f.write(b">seqb1\n" + s2 + b"\n")
        out, out_plain = (os.path.join(tmp, x) for x in ("k.out", "p.out"))
        argv = ["psa", "-1", fa, "-2", fb, "--device", "cuda"] + EDIT_FLAGS
        buf = io.StringIO()
        p0, t0 = start()
        with contextlib.redirect_stdout(buf):
            rc = [cli.main(argv + ["-o", out])]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rc.append(cli.main(argv + ["--notrace"]))
        la, plain_a = stop(p0)
        t2 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc.append(cli.main(argv + ["-o", out_plain, "--kernel", "plain"]))
        t3 = time.perf_counter()
        with open(out, "rb") as f, open(out_plain, "rb") as g:
            text, text_plain = f.read(), g.read()
    ea, eb = encode_dna(s1), encode_dna(s2)
    if len(eb) > len(ea):
        ea, eb = eb, ea
    ref = psa_pallas.psa_align(ea, eb, EDIT, device=dev)   # Q2-13 score-only
    lines = text.split(b"\n")
    rescored = tb.score_alignment(lines[1], lines[3], params)
    stdout = buf.getvalue().split()
    ok_a = (rc == [0, 0, 0] and text == text_plain and rescored == ref.last
            and stdout == ["maxsorce=%d" % max(ref.score, -100)] * 2)
    emit({"phase": "edit_example", "rc": rc, "stdout": stdout,
          "score": ref.score, "corner": ref.last, "rescored": rescored,
          "equal_to_plain_on_card": text == text_plain,
          "launches": la, "plain_calls": plain_a,
          "traced_wall_s": t1 - t0, "notrace_wall_s": t2 - t1,
          "plain_wall_s": t3 - t2, "example": [len(ea), len(eb)],
          "walk_plan": k3_plan(1)})
    if not ok_a or plain_a or la["psa_dp_chunk"] or min(
            la["psa_dp_traced"], la["psa_walk"], la["psa_dp_score"]) < 1:
        raise AssertionError("edit scoring, 10 kbp example: wrong result or "
                             "route: %s %s" % (rc, la))
    launches["psa_r1_dp"] = la["psa_dp_traced"]
    launches["psa_r1_walk"] = la["psa_walk"]

    # the example's DP and walk against their plain versions at its shape
    a, b, nm = psa_diff.pack_pairs([(ea, eb)], dev)
    ms, (ks, kc, plane) = cuda_ms(
        lambda: psa_diff.run_dp(a, b, nm, EDIT, True), 2)
    pms, (ps, pc, pplane) = cuda_ms(
        lambda: psa_scan.scan_rows(a, b, nm[:, 0], nm[:, 1], EDIT, True), 1,
        False)
    dp_err = max(max_err(ks, ps), max_err(kc, pc), max_err(plane, pplane),
                 abs(int(kc) - ref.last))
    del pplane
    wms, (kw, kcnt) = cuda_ms(lambda: tb.walk_packed(plane, nm), 2)
    wpms, (pw, pcnt) = cuda_ms(lambda: tb.walk_packed_plain(plane, nm), 1,
                               False)
    steps = int(kcnt.sum())
    shape = "%d x %d padded to %d x %d, edit scoring" % (
        len(ea), len(eb), plane.shape[2], plane.shape[1])
    plan, sweep = traced_sweep(a, b, nm, EDIT, (ks, kc, plane))
    times["psa_r1_dp"] = {
        "shape": shape + ", traced (the traced DP at P = 1)", "ms": ms,
        "plain_ms": pms, "max_abs_err": max(dp_err, sweep["max_abs_err"]),
        "plan": plan, "sweep": sweep,
        **bound(nbytes(a, b, nm, ks, kc, plane),
                (OPS_PSA_CELL + OPS_PSA_CODE) * plane.numel())}
    times["psa_r1_walk"] = {
        "shape": shape + ", %d steps (K3 at P = 1)" % steps, "ms": wms,
        "plain_ms": wpms,
        "max_abs_err": max(max_err(kw, pw), max_err(kcnt, pcnt)),
        "plan": k3_plan(1), **chain_bound(steps),
        **bound(steps + nbytes(nm, kw, kcnt), OPS_WALK_STEP * steps)}
    del a, b, nm, plane, ks, kc, ps, pc, kw, kcnt, pw, pcnt

    # (b) 128 x 10,240 bp through the score router: the batch kernel (K1)
    route_b = psa_pallas.batch_route(batch_pairs, EDIT)
    p0, t0 = start()
    scores, corners = psa_pallas.psa_align_batch(batch_pairs, EDIT,
                                                 device=dev)
    lb, plain_b = stop(p0)
    wall_b = time.perf_counter() - t0
    a, b, lens = psa_diff.pack_pairs(batch_pairs, dev)
    ms, got = cuda_ms(lambda: psa_diff.run_dp(a, b, lens, EDIT), 3)
    pms, want = cuda_ms(lambda: psa_scan.scan_rows(a, b, lens[:, 0],
                                                   lens[:, 1], EDIT), 1, False)
    routed = (torch.from_numpy(scores), torch.from_numpy(corners))
    err_b = max(*(max_err(g, w) for g, w in zip(got, want[:2])),
                *(max_err(r, w.cpu()) for r, w in zip(routed, want[:2])))
    cells = sum(len(x) * len(y) for x, y in batch_pairs)
    times["psa_r1_batch"] = {
        "shape": "%d x %d bp score-only, edit scoring" % (
            len(batch_pairs), len(batch_pairs[1][0])),
        "ms": ms, "plain_ms": pms, "max_abs_err": err_b,
        **score_bound(nbytes(a, b, lens, *got), cells)}
    emit({"phase": "edit_batch", "route": route_b, "launches": lb,
          "plain_calls": plain_b, "e2e_s": wall_b,
          "e2e_gcups": cells / wall_b / 1e9, "slot0": [int(scores[0]),
                                                       int(corners[0])],
          "times": times["psa_r1_batch"], "smi": smi_line})
    if (route_b != "batch" or err_b or plain_b or lb["psa_dp_score"] != 1
            or int(corners[0]) != ref.last):
        raise AssertionError("edit scoring, 128 x 10,240 bp: wrong result or "
                             "route: %s %s error %d" % (route_b, lb, err_b))
    launches["psa_r1_batch"] = lb["psa_dp_score"]
    del a, b, lens, got, want

    # (c) 4,096 short pairs through the score router: the short-pair kernel
    pairs = short_pairs(np.random.default_rng(SEED + 16), 4096)
    route_c = psa_pallas.batch_route(pairs, EDIT)
    p0, t0 = start()
    scores, corners = psa_pallas.psa_align_batch(pairs, EDIT, device=dev)
    lc, plain_c = stop(p0)
    wall_c = time.perf_counter() - t0
    # the route's first call in this process pays its first launches; a
    # caller's later calls do not
    walls_c = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = psa_pallas.psa_align_batch(pairs, EDIT, device=dev)
        walls_c.append(time.perf_counter() - t0)
    again_ok = all(np.array_equal(x, y) for x, y in zip(again,
                                                        (scores, corners)))
    a, b, lens = psa_diff.pack_pairs(pairs, dev)
    ms, got = cuda_ms(lambda: psa_pallas.dp_short(a, b, lens, EDIT), 3)
    k1_ms, k1 = cuda_ms(lambda: psa_diff.run_dp(a, b, lens, EDIT), 3)
    pms, want = cuda_ms(lambda: psa_scan.scan_rows(a, b, lens[:, 0],
                                                   lens[:, 1], EDIT), 1, False)
    routed = (torch.from_numpy(scores), torch.from_numpy(corners))
    err_c = max(*(max_err(g, w) for g, w in zip(got, want[:2])),
                *(max_err(r, w.cpu()) for r, w in zip(routed, want[:2])))
    err_k1 = max(max_err(g, w) for g, w in zip(k1, want[:2]))
    cells = sum(len(x) * len(y) for x, y in pairs)
    # the plan: one launch of persistent warps, each pair at its strip width
    blocks, per_sm, most = _kernels.psa_dp_short_layout(len(pairs), dev)
    plan_c = {"widths": psa_pallas.short_plan(lens), "launches": 1,
              "blocks": blocks, "warps_per_sm": 4 * per_sm,
              "resident_warps_per_sm": 4 * most}
    times["psa_dp_short"] = {
        "shape": "%d pairs of 150-2,000 bp (%d cells), score-only, edit "
                 "scoring" % (len(pairs), cells),
        "ms": ms, "plain_ms": pms, "k1_ms": k1_ms, "max_abs_err": err_c,
        "plan": plan_c,
        **score_bound(nbytes(a, b, lens, *got), cells)}
    emit({"phase": "edit_short", "route": route_c, "launches": lc,
          "plain_calls": plain_c, "e2e_s": wall_c,
          "e2e_gcups": cells / wall_c / 1e9, "k1_max_abs_err": err_k1,
          "e2e_s_later": walls_c,
          "e2e_gcups_later": cells / statistics.median(walls_c) / 1e9,
          "gcups": cells / ms / 1e6, "k1_gcups": cells / k1_ms / 1e6,
          "ms_over_k1": ms / k1_ms,
          "ms_over_bound": ms / times["psa_dp_short"]["bound_ms"],
          "times": times["psa_dp_short"], "smi": smi_line})
    if (route_c != "short" or err_c or err_k1 or plain_c or not again_ok
            or lc["psa_dp_short"] != plan_c["launches"]
            or lc["psa_dp_score"]):
        raise AssertionError("edit scoring, short pairs: wrong result or "
                             "route: %s %s errors %d %d"
                             % (route_c, lc, err_c, err_k1))
    launches["psa_dp_short"] = lc["psa_dp_short"]
    del a, b, lens, got, k1, want

    # (d) the 200 kbp pair through the CLI, in chunks at the card's budget
    reads = long_reads(13, 200000)
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "r0.fa"), os.path.join(tmp, "r1.fa")
        with open(fa, "wb") as f:
            f.write(b">r0\n" + reads[0] + b"\n")
        with open(fb, "wb") as f:
            f.write(b">r1\n" + reads[1] + b"\n")
        out = os.path.join(tmp, "out.txt")
        buf = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        p0, t0 = start()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["psa", "-1", fa, "-2", fb, "-o", out, "--device",
                           "cuda"] + EDIT_FLAGS)
        ld, plain_d = stop(p0)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        with open(out, "rb") as f:
            lines = f.read().split(b"\n")
    run = psa_chunked.last_clock.record()
    rescored = tb.score_alignment(lines[1], lines[3], params)
    degapped = (lines[1].replace(b"-", b"") == reads[0]
                and lines[3].replace(b"-", b"") == reads[1])
    t0 = time.perf_counter()
    k1_score, k1_corner = (int(x[0]) for x in psa_pallas.psa_align_batch(
        [(encode_dna(reads[0]), encode_dna(reads[1]))], EDIT, device=dev))
    k1_s = time.perf_counter() - t0
    cells = len(reads[0]) * len(reads[1])
    stdout = buf.getvalue().split()
    emit({"phase": "edit_200k", "rc": rc, "stdout": stdout, "wall_s": wall,
          "gcups": cells / wall / 1e9, "cells": cells, "peak_device_gb": peak,
          "launches": {k: ld[k] for k in ("psa_dp_chunk", "psa_walk_bounded",
                                           "psa_dp_traced", "psa_walk")},
          "plain_calls": plain_d, "k1": [k1_score, k1_corner], "k1_s": k1_s,
          "rescored": rescored, "rows_degapped_equal_reads": degapped,
          "lengths": [len(reads[0]), len(reads[1])], **run, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if rc != 0 or stdout != ["maxsorce=%d" % max(k1_score, -100)]:
        raise AssertionError("edit scoring, 200 kbp pair: stdout %s, K1 %d"
                             % (stdout, k1_score))
    if not (run["score"] == k1_score and run["corner"] == k1_corner
            == rescored) or not degapped or run["chunks"] != 3:
        raise AssertionError("edit scoring, 200 kbp pair: score/corner/rows "
                             "disagree with K1, or not 3 chunks")
    times["k1_200k"] = {"score": k1_score, "corner": k1_corner, "s": k1_s}
    times["traced_200k"] = {"score": run["score"], "corner": run["corner"]}
    if (plain_d or ld["psa_dp_chunk"] < run["chunks"] + run["remats"]
            or ld["psa_walk_bounded"] < run["walks"]
            or ld["psa_dp_traced"] or ld["psa_walk"]):
        raise AssertionError("edit scoring, 200 kbp pair did not run on the "
                             "chunked kernels alone: %s %s" % (ld, plain_d))
    return launches, times


def traced_100k_phase(dev, smi_line):
    """Phase 20, a traced mid-length pair: reads 0 and 1 of the 200 kbp set
    cut to 100,000 bp through ``tsta-torch psa --json`` (its plane fits the
    card, so the traced DP at the plan's D shards and K3 run it unchunked),
    the launch counters and the plain calls on the card reset before and
    read after; held to K1's score and corner, the rows re-scoring to the
    corner, and its output bytes to the chunked route's
    (``psa_chunked.psa_align_traced_chunked`` at 8,192 rows a chunk)."""
    import numpy as np
    import torch

    from tsta_tpu_torch import AlignParams, cli
    from tsta_tpu_torch.io import encode_dna
    from tsta_tpu_torch.ops import _kernels, psa_chunked, psa_diff
    from tsta_tpu_torch.ops import traceback as tb
    params = AlignParams()
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    r0, r1 = (r[:TRACED_MID_BP] for r in long_reads(13, 200000)[:2])
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "r0.fa"), os.path.join(tmp, "r1.fa")
        with open(fa, "wb") as f:
            f.write(b">r0\n" + r0 + b"\n")
        with open(fb, "wb") as f:
            f.write(b">r1\n" + r1 + b"\n")
        out = os.path.join(tmp, "out.txt")
        buf = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        p0 = start()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["psa", "-1", fa, "-2", fb, "-o", out, "--device",
                           "cuda", "--json"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = stop(p0)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        with open(out, "rb") as f:
            text = f.read()
        # the same pair score-only: one K1 launch over the plan's shards
        notrace = notrace_cli(fa, fb, (r0, r1))
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    lines = text.split(b"\n")
    rescored = tb.score_alignment(lines[1], lines[3], params)
    degapped = (lines[1].replace(b"-", b"") == r0
                and lines[3].replace(b"-", b"") == r1)
    ea, eb = encode_dna(r0), encode_dna(r1)
    t0 = time.perf_counter()
    k1 = [int(x[0]) for x in psa_diff.psa_align_batch_diff([(ea, eb)], p,
                                                           device=dev)]
    k1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    score_c, corner_c, aln = psa_chunked.psa_align_traced_chunked(
        ea, eb, p, mc=TRACED_MID_MC, device=dev)
    chunked_s = time.perf_counter() - t0
    chunks = psa_chunked.last_clock.chunks
    chunked_text = b">1\n" + aln.a_row + b"\n>2\n" + aln.b_row
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_pad = psa_diff._traced_n_pad(len(r0))
    plan = psa_diff.traced_plan(1, n_pad, sms)
    cells = len(r0) * len(r1)
    notrace["plan"] = dict(zip("DCWT", psa_diff.score_plan(
        1, -(-len(r0) // psa_diff.LANES) * psa_diff.LANES, sms)))
    notrace["gcups"] = cells / notrace["wall_s"] / 1e9
    # K3's own launch on this pair's plane (CUDA events), held to the plain
    # walk on the ring's schedule, which reads only its windows
    a, b, nm = psa_diff.pack_pairs([(ea, eb)], dev, traced=True)
    plane = psa_diff.dp_packed(a, b, nm, p, True)[2]
    del a, b
    k3_ms, (kw, kc) = cuda_ms(lambda: tb.walk_packed(plane, nm), 3)
    n, m = nm[0].tolist()
    moves = torch.zeros(plane.shape[1] + plane.shape[2], dtype=torch.int8)
    t0 = time.perf_counter()
    st = tb.walk_staged_plain(plane[0], torch.zeros(
        plane.shape[2], dtype=torch.uint8, device=dev), 0, m - 1, n - 1, 0,
        0, moves, k3_plan(1)[0]).tolist()
    staged_s = time.perf_counter() - t0
    count = int(kc[0])
    k3_err = abs(count - st[2]) or max_err(torch.from_numpy(tb.unpack_moves(
        kw[0].cpu().numpy(), count)), moves[:count])
    del plane, kw, kc
    k3 = {"ms": k3_ms, "steps": count, "max_abs_err": k3_err,
          "staged_plain_host_s": staged_s, "plan": k3_plan(1),
          **chain_bound(count)}
    emit({"phase": "traced_100k", "k3": k3, "rc": rc, "maxsorce": res["score"],
          "score": res["score"], "corner": res["corner"], "wall_s": wall,
          "gcups": cells / wall / 1e9, "cells": cells,
          "lengths": [len(r0), len(r1)], "peak_device_gb": peak,
          "plan": dict(zip("DCWT", plan)), "n_pad": n_pad,
          "launches": {k: launches[k] for k in (
              "psa_dp_traced", "psa_walk", "psa_dp_chunk",
              "psa_walk_bounded", "psa_dp_score")},
          "plain_calls": plain, "k1": k1, "k1_s": k1_s,
          "rescored": rescored, "rows_degapped_equal_reads": degapped,
          "chunked": {"mc": TRACED_MID_MC, "chunks": chunks,
                      "score": score_c, "corner": corner_c,
                      "wall_s": chunked_s,
                      "bytes_equal": chunked_text == text},
          "notrace": notrace, "smi": smi_line})
    if rc != 0 or [res["score"], res["corner"]] != k1 \
            or rescored != k1[1] or not degapped:
        raise AssertionError("traced 100 kbp pair: score/corner/rows "
                             "disagree with K1: %s %s %d" % (res, k1,
                                                             rescored))
    if chunked_text != text or [score_c, corner_c] != k1 or chunks < 2:
        raise AssertionError("traced 100 kbp pair: the chunked route's "
                             "output differs")
    if (not notrace["one_k1_launch"] or notrace["plan"]["D"] < 2
            or not [notrace["score"], notrace["corner"]]
            == [res["score"], res["corner"]] == notrace["plain"]):
        raise AssertionError("100 kbp pair, --notrace: %s against the "
                             "traced route's %s" % (notrace, res))
    if (plain or launches["psa_dp_traced"] != 1 or launches["psa_walk"] != 1
            or launches["psa_dp_chunk"] or launches["psa_dp_score"]):
        raise AssertionError("traced 100 kbp pair did not run unchunked on "
                             "the traced DP and K3: %s, plain %d"
                             % (launches, plain))
    if k3_err or st[:2] != [-1, -1]:
        raise AssertionError("100 kbp pair: K3 differs from the plain walk "
                             "on the ring's schedule: %s" % k3)
    return {"ms_100k": k3_ms, "chain_bound_ms_100k": k3["chain_bound_ms"]}


def walk_probe_phase(dev, smi_line):
    """Phase 21, the walk probes (``walk_probes.cu``, Q2-17a, b, c, e):
    every mode of each at its script's sizes through
    ``tools.walk_probes.measure``, the launch counters reset before and
    read after; one line a probe.  Fails if an output differs from the
    plain replay, a mode beats its bound, a walker loop is missing from
    the SASS, a time does not grow with N, a probe was not launched, or
    the phase takes 60 s or more.  Returns the launches and the kernels
    record's entries."""
    from tsta_tpu_torch.ops import _kernels
    from tsta_tpu_torch.tools import walk_probes as wp

    t0 = time.perf_counter()
    _kernels.reset_launches()
    recs = wp.measure("abce", reps=5, dev=dev)
    launches = {"walk_probe_" + p: _kernels.launches["walk_probe_" + p]
                for p in "abce"}
    wall = time.perf_counter() - t0
    keys = ("ms", "ms_half", "scaling", "ns_per_step", "ns_per_step_marginal",
            "tpu_unit_ns", "sass_instr_per_step", "sass_loop_instructions",
            "refetches", "bound_ms", "bound_by", "bound_rule", "chain_ms",
            "issue_ms", "bytes_ms", "plain_ms", "equal", "problems")
    times, bad = {}, {}
    for probe in "abce":
        rs = [r for r in recs if r["probe"] == probe]
        modes = {r["mode"]: {k: r[k] for k in keys} for r in rs}
        full = modes[wp.SCRIPTS[probe][1]]
        name = "walk_probe_" + probe
        emit({"phase": name, "replaces": wp.SCRIPTS[probe][0],
              "sizes": wp.SIZES[probe], "modes": modes,
              "launches": launches[name], "smi": smi_line})
        bad.update({"%s %s" % (probe, m): v["problems"]
                    for m, v in modes.items() if v["problems"]})
        times[name] = {**{k: full[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")},
                       "max_abs_err": max(r["max_abs_err"] for r in rs),
                       "shape": wp.SIZES[probe], "modes": modes}
    emit({"phase": "walk_probes", "wall_s": wall, "launches": launches,
          "smi": smi_line})
    if bad or min(launches.values()) < 1 or wall >= 60:
        raise AssertionError("walk probes: %s, launches %s, %.1f s"
                             % (bad, launches, wall))
    return launches, times


def chunking_budget(g, seq, params) -> int:
    """The largest budget, in steps of 1 MiB below twice the wide plane's
    bytes, at which ``seq``'s round against ``g`` plans its int32 plane
    in chunks (its 16-bit plane would then run as one call)."""
    from tsta_tpu_torch.ops import msa_poa
    prep, n = msa_poa.prep_round(g, seq, params, 1 << 40)[:2]
    N, W = prep[4], prep[6]
    for b in range(8 * N * n - 1, 0, -(1 << 20)):
        try:
            if msa_poa.round_plan(N, n, W, b, 4):
                return b
        except ValueError:
            pass
    raise AssertionError("no budget chunks the wide round")


def wide_phases(dev, smi_line):
    """Phase 22: MSA rounds past 64 preds through the kernels' wide forms
    (32-bit words, 13-bit pred fields), the launch counters and the count
    of plain calls reset before each path and read after.  Returns the
    paths' launches of the wide kernels and their timing records."""
    import torch

    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import _kernels, msa_native, msa_poa
    params = AlignParams()
    t_phase = time.perf_counter()
    narrow_kernels = ("poa_dp", "poa_walk", *CHUNK_KERNELS)

    # (a) phase 7's first grown graph with node WIDE_AT's in-degree raised
    # to each of WIDE_IN, its next read a deletion into that node
    base = grown_reads(1)
    errs = {"poa_dp_wide": 0, "poa_walk_wide": 0}
    small = []
    for k in WIDE_IN:
        d = min(k - 1, 600)
        reads = base[:3] + [deletion_read(base[0], WIDE_AT, d, SEED + k)]
        _kernels.reset_launches()
        r = next_round(reads, 2, params, dev, stair=(k, WIDE_AT))
        dp, walk = poa_compare(r, params, 1, False, POA_WIDE_FORCED,
                               POA_WALK_FORCED_WIDE)
        # the pred the walk took into the staircase node
        words, scores = msa_poa.poa_dp(*r["tables"], r["n_real"],
                                       r["n_nodes"], params, r["W"],
                                       lists=r["lists"])
        best = msa_poa.best_sink(scores, r["mask"])
        align = msa_poa.poa_walk(words, r["preds"], best, r["n_real"]).cpu()
        row = r["order"].index(WIDE_AT)
        cols = (align == row).nonzero().flatten().tolist()
        index = (int(words[row, cols[0]]) >> 4) & 8191 if cols else None
        launched = {x: v for x, v in _kernels.launches.items() if v}
        errs["poa_dp_wide"] = max(errs["poa_dp_wide"], dp["max_abs_err"])
        errs["poa_walk_wide"] = max(errs["poa_walk_wide"],
                                    walk["max_abs_err"])
        small.append({"in_degree": k, "deletion": d, "shape": r["shape"],
                      "stair_pred_index": index, "launches": launched,
                      "dp": {x: dp[x] for x in ("ms", "plain_ms", "plan",
                                                "forced", "max_abs_err")},
                      "walk": {x: walk[x] for x in (
                          "ms", "plain_ms", "maxdist", "plan", "counts",
                          "forced", "max_abs_err")}})
        if index is None or index < msa_poa.MAX_IN \
                or any(launched.get(x) for x in narrow_kernels):
            raise AssertionError("phase 22 (a): in-degree %d walked in by "
                                 "index %s, launches %s" % (k, index,
                                                            launched))
        del r, words, scores
    emit({"phase": "wide_small", "max_abs_err": errs, "rounds": small,
          "smi": smi_line})
    if any(errs.values()):
        raise AssertionError("a wide form differs from its plain version: "
                             "%s" % errs)

    # (a) a chunked wide round: in-degree 129, a 2,048-column read
    k = 129
    read = deletion_read(base[0], WIDE_AT, k - 1, SEED + k) + base[4][:160]
    g = PoaGraph.from_sequence(base[0], 4)
    staircase(g, k, WIDE_AT)
    for sno in (1, 2):
        packed, order, _ = msa_poa.run_round(g, base[sno], params, dev,
                                             "cuda", 1 << 40)
        msa_native._finish_round(g, base[sno], sno, order,
                                 packed.cpu().numpy(), [], [], [])
    budget = chunking_budget(g, read, params)
    p0 = start()
    with counting_plain() as calls:
        got, _, plain_k = msa_poa.run_round(g, read, params, dev, "cuda",
                                            budget)
        torch.cuda.synchronize()
    chunk_launches, _ = stop(p0)
    plain_calls = dict(calls)
    want, _, plain_p = msa_poa.run_round(g, read, params, dev, "plain",
                                         budget)
    whole, _, _ = msa_poa.run_round(g, read, params, dev, "cuda", 1 << 40)
    chunk_times = hold_round(dev, g, read, "grown 2 kbp graph, in-degree 129",
                             False, budget)[0]
    chunk_ok = (torch.equal(got, want) and torch.equal(got, whole)
                and not plain_k and plain_p)
    wide_chunk = ("poa_dp_chunk_wide", "poa_dp_window_wide",
                  "poa_walk_bounded_wide")
    emit({"phase": "wide_chunked", "budget": budget, "equal": chunk_ok,
          "launches": {x: v for x, v in chunk_launches.items() if v},
          "plain_calls": plain_calls, "times": chunk_times,
          "smi": smi_line})
    if not chunk_ok or any(plain_calls.values()) \
            or min(chunk_launches[x] for x in wide_chunk) < 1 \
            or any(chunk_launches[x] for x in narrow_kernels) \
            or any(t["max_abs_err"] for t in chunk_times.values()):
        raise AssertionError("phase 22 (a): the chunked wide round differs "
                             "or left the wide kernels")
    del g, got, want, whole

    # (b) 3 x 50 kbp with a staircase at node WIDE_50K[1] from round 1 on,
    # through align_seqs and align_seqs_many beside a narrow problem, then
    # the plain route (the parent's) once
    seqs, narrow = long_reads(), fleet_problem(100)
    with staircased(*WIDE_50K, 20000):
        clock = msa_poa.RoundClock(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        p0 = start()
        r0 = msa_native.plain_rounds
        with counting_plain() as calls:
            t0 = time.perf_counter()
            out = msa_native.align_seqs(seqs, params, kernel="cuda",
                                        device=dev, clock=clock)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, _ = stop(p0)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            fleet = msa_native.align_seqs_many([seqs, narrow], params,
                                               kernel="cuda", device=dev)
            torch.cuda.synchronize()
        plain_rounds = msa_native.plain_rounds - r0
        plain_calls = dict(calls)
        fleet_ok = (fleet[0] == out and fleet[1] == msa_native.align_seqs(
            narrow, params, device=dev))
        pclock = msa_poa.RoundClock(dev)
        t0 = time.perf_counter()
        pout = msa_native.align_seqs(seqs, params, kernel="plain",
                                     device=dev, clock=pclock)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    same = out == pout

    # round 2's DP and walk (median of 3), beside the 16-bit build on the
    # graph without the staircase
    times, rounds2 = {}, {}
    for label, stair in (("wide", WIDE_50K), ("16-bit", None)):
        r = next_round(seqs, 1, params, dev, stair=stair)
        args = (*r["tables"], r["n_real"], r["n_nodes"], params, r["W"])
        ms, (kw, ks) = cuda_ms(lambda: msa_poa.poa_dp(
            *args, lists=r["lists"]), 3)
        best = msa_poa.best_sink(ks, r["mask"])
        maxdist = msa_poa.max_pred_distance(r["preds"].cpu().numpy())
        counts = torch.zeros((4,), dtype=torch.int32, device=dev)
        wms, kal = cuda_ms(lambda: msa_poa.poa_walk(
            kw, r["preds"], best, r["n_real"], maxdist=maxdist,
            counts=counts), 3)
        rec = (wide_walk_record(counts.tolist(), kw, r["preds"], int(best),
                                r["n_real"] - 1, maxdist) if stair else
               poa_walk_record(counts.tolist(), maxdist,
                               r["preds"].shape[1]))
        rounds2[label] = {"shape": r["shape"], "dp_ms": ms, "walk_ms": wms,
                          "dp_plan": list(msa_poa.poa_plan(
                              r["tables"][4].shape[0])),
                          "walk": rec}
        if stair:
            pal = msa_poa.walk_plain(kw, r["preds"], best, r["n_real"])
            nn, c = r["n_nodes"], rec["counts"]
            times["poa_dp_wide"] = {
                "shape": "50 kbp round 2, in-degree %d: %s" % (
                    WIDE_50K[0], r["shape"]), "ms": ms,
                "plain_ms": pclock.rounds[1]["dp_ms"],
                "max_abs_err": max(errs["poa_dp_wide"], int(not same)),
                "plan": rounds2[label]["dp_plan"],
                **poa_wide_bound(nbytes(*r["tables"], *r["lists"], kw, ks),
                                 chunk_ops(r["tables"][:2], nn,
                                           r["tables"][4].shape[0], True))}
            times["poa_walk_wide"] = {
                "shape": times["poa_dp_wide"]["shape"], "ms": wms,
                "plain_ms": pclock.rounds[1]["walk_ms"],
                "max_abs_err": max(errs["poa_walk_wide"],
                                   max_err(kal, pal)),
                "maxdist": maxdist, **rec,
                **poa_wide_bound(c["moves"] * 4 + c["pred_moves"] * 4
                                 + r["n_real"] * 4 + 4,
                                 OPS_WALK_STEP * c["moves"])}
        del r, args, kw, ks, kal
    for x, key in (("poa_dp_chunk_wide", "poa_dp_chunk"),
                   ("poa_dp_window_wide", "poa_dp_window"),
                   ("poa_walk_bounded_wide", "poa_walk_bounded")):
        times[x] = chunk_times[key]
    wide_launches = {x: launches[x] for x in ("poa_dp_wide", "poa_walk_wide")}
    wide_launches.update({x: chunk_launches[x] for x in wide_chunk})
    emit({"phase": "wide_50k", "equal_to_plain_route": same,
          "fleet_equal": fleet_ok, "wall_s": wall,
          "cells_per_s": msa_cells(seqs, out) / wall,
          "peak_device_gb": peak, "rounds": out.round_scores,
          "graph_len": out.graph_len, "launches": {
              x: v for x, v in launches.items() if v},
          "plain_rounds": plain_rounds, "plain_calls": plain_calls,
          "rounds_split": clock.rounds, "plain_route_wall_s": plain_wall,
          "plain_route_rounds_split": pclock.rounds, "round2": rounds2,
          "phase_s": time.perf_counter() - t_phase, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if not same or not fleet_ok or plain_rounds \
            or any(plain_calls.values()) \
            or (launches["poa_dp_wide"], launches["poa_walk_wide"]) != (2, 2) \
            or any(launches[x] for x in narrow_kernels) \
            or any(t["max_abs_err"] for t in times.values()):
        raise AssertionError("phase 22 (b): the wide 3 x 50 kbp run differs "
                             "from the plain route or left the kernels")
    return wide_launches, times


def start():
    """Reset the launch counters before a path; returns the count of plain
    calls so far, for :func:`stop`."""
    import torch

    from tsta_tpu_torch.ops import _kernels, psa_scan
    torch.cuda.synchronize()
    _kernels.reset_launches()
    return psa_scan.plain_calls


def stop(p0):
    """The launch counters and the plain calls on the card since
    :func:`start` returned ``p0``."""
    import torch

    from tsta_tpu_torch.ops import _kernels, psa_scan
    torch.cuda.synchronize()
    return dict(_kernels.launches), psa_scan.plain_calls - p0


def layout_forced(run, P, want, k1, limit):
    """A score-only layout's kernel (``run(D)``: its (score, corner) at a
    forced D) at each of ``LAYOUT_FORCED_D`` on P pairs, every output held
    to ``want`` (the plain version's) and ``k1``.  ``limit(D)`` is the
    kernel's resident limit at that D's shards, read from the card: a D >=
    2 whose P * D blocks exceed it must raise the kernel's own
    ``KernelError`` naming the limit (recorded as ``past_limit``), and
    any other D must run, so a wrong occupancy query cannot pass a D
    unrun.  Returns {D: error or the raise}."""
    from tsta_tpu_torch.ops import _kernels
    out = {}
    for D in LAYOUT_FORCED_D:
        most = limit(D) if D >= 2 else None
        try:
            got = run(D)
        except _kernels.KernelError as e:
            if most is None or P * D <= most or \
                    "at most %d " % most not in str(e):
                raise
            out[D] = {"past_limit": str(e)[:160], "blocks": P * D,
                      "limit": most}
            continue
        if most is not None and P * D > most:
            raise AssertionError("%d blocks past the resident limit %d ran "
                                 "at D = %d" % (P * D, most, D))
        out[D] = max(max(max_err(g, w), max_err(g, k))
                     for g, w, k in zip(got, want, k1))
    return out


def layout_sweep(run, plans, want):
    """The same group at the D of each plan of ``plans`` ({label: (D, W)}),
    ``run(D)`` timed (CUDA events, median of 3 after a warm-up), every
    output held to ``want``."""
    runs, err = {}, 0
    for label, (D, W) in plans.items():
        if D not in runs:
            ms, got = cuda_ms(lambda: run(D), 3)
            err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
            runs[D] = {"D": D, "W": W, "ms": ms}
        runs[D].setdefault("plans", []).append(label)
    return {"max_abs_err": err, "runs": list(runs.values())}


def int16_phases(dev, smi_line, batches, batch_pairs):
    """Phase 17, the difference method: (a) ``batches`` (phase 3's mixed
    batch and 40 kbp pair) through ``psa_dp_diff.cu`` at its plan and at
    forced D against the plain version and K1; (b) the D = 57 sets, and
    the kernel's plan against ``psa_diff.diff_plan``; (c) the int32/int16
    probe on 32 x 10,240 bp and the kernel's times, plan, forced D and
    sweep at ``batch_pairs`` (phase 5's 128 x 10,240 bp); (d) ``tsta-torch
    psa --notrace`` with ``TSTA_DIFF_INT16``; (e) the dtype-max probe
    (Q2-17d) against numpy.  Each path runs with the launch counters and
    the count of plain calls on the card reset before it and read after
    it.  Returns the CLI path's launches and the kernels record's
    timing."""
    import numpy as np
    import torch

    from tsta_tpu_torch import cli
    from tsta_tpu_torch.ops import _kernels, psa_diff
    from tsta_tpu_torch.tools import dtype_max_probe

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def diff_limit(n_pad):
        """The int16 DP's resident limit at D shards of n_pad columns."""
        return lambda D: _kernels.psa_dp_diff_max_blocks(
            *psa_diff.diff_shards(n_pad, D)[1:], psa_diff.SCORE_T, dev)

    def check(label, pairs, params):
        a, b, lens = psa_diff.pack_pairs(pairs, dev)
        plan = psa_diff.diff_plan(len(pairs), a.shape[1], sms)
        p0 = start()
        got = psa_diff.run_dp_int16(a, b, lens, params)
        ld, plain = stop(p0)
        want = psa_diff.dp_int16_plain(a, b, lens, params, plan[3])
        k1 = psa_diff.run_dp(a, b, lens, params)
        rec = {"case": label, "pairs": len(pairs), "params": list(params),
               "n_max": int(lens[:, 0].max()), "plan": plan,
               "plain_calls": plain, "launches": ld["psa_dp_diff"],
               "k1_launches": ld["psa_dp_score"],
               "max_abs_err": max(max_err(g, w) for g, w in zip(got, want)),
               "k1_max_abs_err": max(max_err(g, k) for g, k in zip(got, k1)),
               "slot0": [int(got[0][0]), int(got[1][0])],
               "forced": layout_forced(lambda D: psa_diff.run_dp_int16(
                   a, b, lens, params, D=D), len(pairs), want, k1,
                   diff_limit(a.shape[1]))}
        if (rec["max_abs_err"] or rec["k1_max_abs_err"] or plain
                or rec["launches"] != 1 or rec["k1_launches"]
                or any(v for v in rec["forced"].values()
                       if not isinstance(v, dict))):
            raise AssertionError("int16 kernel, %s: %s" % (label, rec))
        return rec

    # (a) phase 3's pairs, (b) the gate's edge
    rng = np.random.default_rng(SEED + 17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    same = [acgt[rng.integers(0, 4, 10240)] for _ in range(8)]
    p = (2, -5, -2, -4)
    cases = [check("phase 3 mixed", batches[0], p),
             check("40 kbp", batches[1], p),
             check("8 identical x 10,240", [(x, x) for x in same], D57[0]),
             check("phase 3 mixed", batches[0], D57[1])]
    if cases[2]["slot0"] != [57 * 10240] * 2:
        raise AssertionError("identical pairs under %s: %s"
                             % (D57[0], cases[2]["slot0"]))
    # the plain version's plan is the kernel's, read from the library, at
    # every width to 4,096 in steps of 12 and beyond, to 200 kbp
    plans = [(P, n, s) for s in sorted({1, 16, 132, sms})
             for P in (1, 2, 3, 32, 128, 200, 5000)
             for n in list(range(4, 4097, 12)) + [9088, 10112, 10240, 30720,
                                                  40064, 100096, 200064]]
    drift = [c for c in plans
             if _kernels.psa_dp_diff_plan(*c) != psa_diff.diff_plan(*c)]
    emit({"phase": "int16_kernels", "cases": cases,
          "plans_checked": len(plans), "plans_differing": drift[:10]})
    if drift:
        raise AssertionError("diff_plan differs from psa_dp_diff.cu's "
                             "plan at %s" % drift[:10])

    # (c) bench.stage_int16_probe's shape and keys: int32 and int16 in turns
    s1, s2 = golden_example()
    ex = (np.frombuffer(s1, np.uint8), np.frombuffer(s2, np.uint8))
    brng = np.random.default_rng(0)
    pairs32 = [ex] + [(brng.integers(65, 69, 10240).astype(np.uint8),
                       brng.integers(65, 69, 10240).astype(np.uint8))
                      for _ in range(31)]
    cells32 = sum(len(x) * len(y) for x, y in pairs32)
    walls = {"int32": [], "int16": []}
    outs = {}
    p0 = start()
    for _ in range(6):   # the first of each is a warm-up
        for label in ("int32", "int16"):
            t0 = time.perf_counter()
            outs[label] = psa_diff.psa_align_batch_diff(
                pairs32, p, use_int16=label == "int16", device=dev)
            walls[label].append(time.perf_counter() - t0)
    lc, plain_c = stop(p0)
    med = {k: statistics.median(v[1:]) for k, v in walls.items()}
    probe = {"psa_batch_int32_gcups": cells32 / med["int32"] / 1e9,
             "psa_batch_int16_gcups": cells32 / med["int16"] / 1e9,
             "int16_speedup": med["int32"] / med["int16"],
             "psa_batch_int16_exact": int(outs["int16"][0][0]) == -5,
             "psa_batch_int32_exact": int(outs["int32"][0][0]) == -5,
             "equal": all(np.array_equal(x, y) for x, y in
                          zip(outs["int16"], outs["int32"])),
             "walls_s": walls, "launches": lc, "plain_calls": plain_c}

    a, b, lens = psa_diff.pack_pairs(batch_pairs, dev)
    cells = sum(len(x) * len(y) for x, y in batch_pairs)
    P, n_pad = a.shape
    plan = psa_diff.diff_plan(P, n_pad, sms)
    ms, got = cuda_ms(lambda: psa_diff.run_dp_int16(a, b, lens, p), 3)
    k1_ms, k1 = cuda_ms(lambda: psa_diff.run_dp(a, b, lens, p), 3)
    pms, want = cuda_ms(lambda: psa_diff.dp_int16_plain(a, b, lens, p,
                                                        plan[3]), 1, False)
    err = max(max_err(g, w) for g, w in zip(got, want))
    err_k1 = max(max_err(g, k) for g, k in zip(got, k1))
    forced = layout_forced(lambda D: psa_diff.run_dp_int16(
        a, b, lens, p, D=D), P, want, k1, diff_limit(n_pad))

    def sweep_plans(n_pairs):
        return {"min W %d, %d a SM" % (w, k): psa_diff.diff_plan(
            n_pairs, n_pad, sms, w, k)[0:3:2]
            for w in SCORE_MIN_W_SWEEP for k in SCORE_PER_SM_SWEEP}
    sweep = {"128 x 10,240": layout_sweep(lambda D: psa_diff.run_dp_int16(
        a, b, lens, p, D=D), sweep_plans(P), want)}
    times = {"psa_dp_diff": {
        "shape": "%d x %d bp score-only, int16 offsets" % (
            len(batch_pairs), len(batch_pairs[1][0])),
        "ms": ms, "plain_ms": pms, "k1_ms": k1_ms, "max_abs_err": err,
        "plan": dict(zip("DCWGT", plan)), "forced": forced, "sweep": sweep,
        **score_bound(nbytes(a, b, lens, *got), cells, CELLS_PER_S16X2)}}
    del a, b, lens, got, k1, want
    a, b, lens = psa_diff.pack_pairs(pairs32, dev)
    want32 = psa_diff.run_dp(a, b, lens, p)
    sweep["32 x 10,240"] = layout_sweep(lambda D: psa_diff.run_dp_int16(
        a, b, lens, p, D=D), sweep_plans(len(pairs32)), want32)
    sweep["32 x 10,240"]["plan"] = psa_diff.diff_plan(len(pairs32), n_pad,
                                                      sms)
    sweep["32 x 10,240"]["k1_plan"] = psa_diff.score_plan(len(pairs32),
                                                          n_pad, sms)
    del a, b, lens, want32
    emit({"phase": "int16_probe", **probe, "k1_max_abs_err": err_k1,
          "gcups": cells / ms / 1e6, "k1_gcups": cells / k1_ms / 1e6,
          "times": times["psa_dp_diff"], "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if not (probe["psa_batch_int16_exact"] and probe["psa_batch_int32_exact"]
            and probe["equal"]) or err or err_k1 or plain_c \
            or lc["psa_dp_diff"] != 6 or lc["psa_dp_score"] != 6 \
            or any(v for v in forced.values() if not isinstance(v, dict)) \
            or any(v["max_abs_err"] for v in sweep.values()):
        raise AssertionError("int16 probe: wrong result or route: %s, "
                             "errors %d %d, forced %s" % (probe, err, err_k1,
                                                          forced))

    # (d) the CLI: --json in a subprocess, maxsorce in this process
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "seqa1.fa"), os.path.join(tmp, "seqb1.fa")
        with open(fa, "wb") as f:
            f.write(b">seqa1\n" + s1 + b"\n")
        with open(fb, "wb") as f:
            f.write(b">seqb1\n" + s2 + b"\n")
        argv = ["psa", "--notrace", "-1", fa, "-2", fb, "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tsta_tpu_torch"] + argv + ["--json"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, TSTA_DIFF_INT16="1"))
        t_sub = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError("TSTA_DIFF_INT16=1 tsta_tpu_torch psa "
                               "--notrace failed:\n" + proc.stderr)
        js = json.loads(proc.stdout.strip().splitlines()[-1])
        buf = io.StringIO()
        os.environ["TSTA_DIFF_INT16"] = "1"
        try:
            p0 = start()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            ld, plain_d = stop(p0)
            wall = time.perf_counter() - t0
        finally:
            del os.environ["TSTA_DIFF_INT16"]
    stdout = buf.getvalue().split()
    emit({"phase": "int16_cli", "score": js["score"], "corner": js["corner"],
          "json_launches": {k: js["launches"][k]
                            for k in ("psa_dp_diff", "psa_dp_score")},
          "json_wall_s": js["wall_s"], "subprocess_wall_s": t_sub, "rc": rc,
          "stdout": stdout, "wall_s": wall, "launches": ld,
          "plain_calls": plain_d,
          "plan": psa_diff.diff_plan(1, -(-len(s1) // 128) * 128, sms)})
    if (js["score"] != -5 or js["launches"]["psa_dp_diff"] < 1
            or js["launches"]["psa_dp_score"] or rc != 0
            or stdout != ["maxsorce=-5"] or plain_d
            or ld["psa_dp_diff"] != 1 or sum(ld.values()) != 1):
        raise AssertionError("TSTA_DIFF_INT16 CLI: wrong result or route: "
                             "%s %s %s" % (js, stdout, ld))

    # (e) the dtype-max probe (Q2-17d): every form equal to numpy
    n0 = dtype_max_probe.launches
    res = dtype_max_probe.measure(dev=dev)
    emit({"phase": "dtype_max_probe", "iters": 2000, "copies": 256,
          "forms": {k: {f: v[f] for f in ("ms", "plain_ms",
                                           "ns_per_tile_max",
                                           "lanes_per_clock",
                                           "speed_over_int32_form",
                                           "bound_ms", "bound_by", "equal")}
                    for k, v in res.items()},
          "launches": dtype_max_probe.launches, "smi": smi_line})
    if not all(v["equal"] for v in res.values()):
        raise AssertionError("dtype_max_probe differs from numpy: %s"
                             % {k: v["equal"] for k, v in res.items()})
    # the issue rate is a floor no form can beat: one that did would show
    # a wrong count of its instructions
    if any(v["ms"] < v["bound_ms"] for v in res.values()):
        raise AssertionError("dtype_max_probe beat its bound: %s"
                             % {k: (v["ms"], v["bound_ms"])
                                for k, v in res.items()})
    # the kernels record: the int32 form, every form beside it
    times["dtype_max_probe"] = {
        **{k: res["int32"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "max_abs_err": max(v["max_abs_err"] for v in res.values()),
        "shape": [256, 256, 128], "iters": 2000,
        "modes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms")}
                  for k, v in res.items()}}
    return {"psa_dp_diff": ld["psa_dp_diff"],
            "dtype_max_probe": dtype_max_probe.launches - n0}, times


def striped_phases(dev, smi_line, batches, batch_pairs, tpairs, walk_plain,
                   short_batch):
    """Phase 18, the striped layout and the two-pair walk: (a) ``batches``
    (phase 3's mixed batch and 40 kbp pair) through
    ``psa_align_batch_diff(layout="striped")`` against K1 and, on the mixed
    batch, the plain version; (b) the kernel's, K1's and the plain
    version's times at ``batch_pairs`` (phase 5's 128 x 10,240 bp); (c)
    ``TSTA_PSA_LAYOUT=striped tsta-torch batch`` on those pairs; (d) the
    walks of ``tpairs``' traced plane (phase 5's 32 x 10 kbp), held to
    ``walk_plain``, phase 6's plain walk of that plane (words, counts,
    ms), and the groups of phase 6 (b)'s traced batch of 4,096 short pairs
    (``short_batch``: its pairs, groups and plain walks).  Each path runs
    with the launch counters and the count of plain calls on the card
    reset before it and read after it.  Returns the launches of (c) and
    (d)'s two-pair walk and the kernels record's timings."""
    import numpy as np
    import torch

    from tsta_tpu_torch import cli
    from tsta_tpu_torch.ops import _kernels, psa_diff
    from tsta_tpu_torch.ops import traceback as tb

    p = (2, -5, -2, -4)

    def errs(got, want):
        return max(max_err(torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu())
                   for g, w in zip(got, want))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def striped_limit(n_pad):
        """The striped DP's resident limit at D shards of n_pad columns."""
        return lambda D: _kernels.psa_dp_striped_max_blocks(
            -(-n_pad // D), psa_diff.SCORE_T, dev)

    # (a) phase 3's pairs through the layout's route, against K1 and the
    # plain version (the 40 kbp pair's 39,700 rows: K1 only), then the
    # kernel at forced D
    cases = []
    for label, pairs in (("phase 3 mixed", batches[0]),
                         ("40 kbp", batches[1])):
        p0 = start()
        got = psa_diff.psa_align_batch_diff(pairs, p, layout="striped",
                                            device=dev)
        ld, plain = stop(p0)
        a, b, lens = psa_diff.pack_pairs(pairs, dev)
        k1 = psa_diff.run_dp(a, b, lens, p)
        tile, tb_, tl = psa_diff.pack_pairs_striped(pairs, dev)
        rec = {"case": label, "pairs": len(pairs), "plain_calls": plain,
               "launches": ld["psa_dp_striped"],
               "k1_launches": ld["psa_dp_score"],
               "k1_max_abs_err": errs(got, k1), "sp": tile.shape[1],
               "plan": psa_diff.score_plan(len(pairs), tile.shape[1] * 128,
                                           sms),
               "slot0": [int(got[0][0]), int(got[1][0])]}
        want = k1
        if label != "40 kbp":
            want = psa_diff.scan_rows_striped(tile, tb_, tl, p)
            rec["max_abs_err"] = errs(got, want)
        rec["forced"] = layout_forced(lambda D: psa_diff.run_dp_striped(
            tile, tb_, tl, p, D=D), len(pairs), want, k1,
            striped_limit(tile.shape[1] * 128))
        cases.append(rec)
        if (rec["k1_max_abs_err"] or rec.get("max_abs_err") or plain
                or rec["launches"] != 1 or rec["k1_launches"]
                or any(v for v in rec["forced"].values()
                       if not isinstance(v, dict))):
            raise AssertionError("striped layout, %s: %s" % (label, rec))

    # (b) the kernel, K1 and the plain version on the same pairs; forced D
    # and the plan's sweep
    tile, tb_, tl = psa_diff.pack_pairs_striped(batch_pairs, dev)
    a, b, lens = psa_diff.pack_pairs(batch_pairs, dev)
    cells = sum(len(x) * len(y) for x, y in batch_pairs)
    P, n_pad = len(batch_pairs), tile.shape[1] * 128
    ms, got = cuda_ms(lambda: psa_diff.run_dp_striped(tile, tb_, tl, p), 3)
    k1_ms, k1 = cuda_ms(lambda: psa_diff.run_dp(a, b, lens, p), 3)
    pms, want = cuda_ms(lambda: psa_diff.scan_rows_striped(tile, tb_, tl, p),
                        1, False)
    forced = layout_forced(lambda D: psa_diff.run_dp_striped(
        tile, tb_, tl, p, D=D), P, want, k1, striped_limit(n_pad))
    sweep = layout_sweep(lambda D: psa_diff.run_dp_striped(
        tile, tb_, tl, p, D=D), {
            "min W %d, %d a SM" % (w, k): psa_diff.score_plan(
                P, n_pad, sms, w, k)[0:3:2]
            for w in SCORE_MIN_W_SWEEP for k in SCORE_PER_SM_SWEEP}, want)
    times = {"psa_dp_striped": {
        "shape": "%d x %d bp score-only, striped tiles of Sp %d" % (
            len(batch_pairs), len(batch_pairs[1][0]), tile.shape[1]),
        "ms": ms, "plain_ms": pms, "k1_ms": k1_ms,
        "max_abs_err": errs(got, want), "k1_max_abs_err": errs(got, k1),
        "plan": dict(zip("DCWT", psa_diff.score_plan(P, n_pad, sms))),
        "forced": forced, "sweep": sweep,
        **score_bound(nbytes(tile, tb_, tl, *got), cells)}}
    emit({"phase": "striped_kernels", "cases": cases,
          "times": times["psa_dp_striped"], "gcups": cells / ms / 1e6,
          "k1_gcups": cells / k1_ms / 1e6, "smi": smi_line})
    if times["psa_dp_striped"]["max_abs_err"] or \
            times["psa_dp_striped"]["k1_max_abs_err"] or sweep["max_abs_err"] \
            or any(v for v in forced.values() if not isinstance(v, dict)):
        raise AssertionError("striped kernel differs at %s: %s"
                             % (times["psa_dp_striped"]["shape"],
                                times["psa_dp_striped"]))
    del tile, tb_, tl, a, b, lens, got, k1, want

    # (c) the batch CLI: the default run in this process (K1), the layout's
    # in a subprocess, the same scores TSV
    with tempfile.TemporaryDirectory() as tmp:
        rows = []
        for k, (x, y) in enumerate(batch_pairs):
            for side, seq in (("a", x), ("b", y)):
                with open(os.path.join(tmp, "%d%s.fa" % (k, side)), "wb") as f:
                    f.write(b">s%d%s\n" % (k, side.encode())
                            + np.asarray(seq, np.uint8).tobytes() + b"\n")
            rows.append("p%03d\t%s\t%s\n" % (
                k, os.path.join(tmp, "%da.fa" % k),
                os.path.join(tmp, "%db.fa" % k)))
        manifest = os.path.join(tmp, "pairs.tsv")
        with open(manifest, "w") as f:
            f.writelines(rows)
        argv = ["batch", "--pairs", manifest, "--device", "cuda", "--scores"]
        buf = io.StringIO()
        p0 = start()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + [os.path.join(tmp, "default.tsv")])
        ld, plain_d = stop(p0)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tsta_tpu_torch"] + argv
            + [os.path.join(tmp, "striped.tsv")], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, TSTA_PSA_LAYOUT="striped"))
        t_sub = time.perf_counter() - t0
        if proc.returncode != 0 or rc != 0:
            raise RuntimeError("tsta_tpu_torch batch failed (rc %d):\n%s"
                               % (rc, proc.stderr))
        js = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(tmp, "default.tsv")) as f:
            want_tsv = f.read()
        with open(os.path.join(tmp, "striped.tsv")) as f:
            got_tsv = f.read()
    first = got_tsv.split("\n", 1)[0]
    emit({"phase": "striped_cli", "pairs": js["pairs"], "rows_equal":
          got_tsv == want_tsv, "first_row": first,
          "launches": {k: js["launches"][k]
                       for k in ("psa_dp_striped", "psa_dp_score")},
          "default_launches": {k: ld[k]
                               for k in ("psa_dp_striped", "psa_dp_score")},
          "default_plain_calls": plain_d, "wall_s": js["wall_s"],
          "gcups": js["gcups"], "subprocess_wall_s": t_sub})
    if (got_tsv != want_tsv or first != "p000\t-5"
            or js["launches"]["psa_dp_striped"] < 1
            or js["launches"]["psa_dp_score"] or plain_d
            or ld["psa_dp_score"] < 1 or ld["psa_dp_striped"]):
        raise AssertionError("TSTA_PSA_LAYOUT=striped batch: wrong result "
                             "or route: %s %s" % (js, ld))

    # (d) the two-pair walk
    lw, times["psa_walk_pair2"] = pair2_walks(dev, smi_line, tpairs,
                                              walk_plain, short_batch)
    return {"psa_dp_striped": js["launches"]["psa_dp_striped"],
            "psa_walk_pair2": lw}, times


def pair2_walks(dev, smi_line, tpairs, walk_plain, short_batch):
    """Phase 18 (d), the two-pair walk (``psa_walk_pair2.cu``): the walks
    of ``tpairs``' traced plane (phase 5's 32 x 10 kbp), held to
    ``walk_plain``, phase 6's plain walk of it (words, counts, ms), then
    its first 31 pairs, which take K3; then the groups of phase 6 (b)'s
    traced batch of 4,096 short pairs (``short_batch``: its pairs, groups
    and plain walks), an odd group taking K3, both walks timed over all
    groups and over the even ones.  Each path runs with the
    launch counters and the count of plain calls on the card reset before
    it and read after it.  Returns the two-pair walk's launches on the 32 x
    10 kbp plane and the kernels record's timing."""
    import torch

    from tsta_tpu_torch.ops import _kernels, psa_diff
    from tsta_tpu_torch.ops import traceback as tb

    p = (2, -5, -2, -4)

    def errs(got, want):
        return max(max_err(torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu())
                   for g, w in zip(got, want))

    # the walks of phase 5's traced plane (K2's, which phase 6 held to the
    # plain DP, on the same pairs): the two-pair walk's path, then both
    # walks timed, each held to phase 6's plain walk; 31 pairs take K3
    a, b, nm = psa_diff.pack_pairs(tpairs, dev, traced=True)
    plane = psa_diff.dp_packed(a, b, nm, p, traced=True)[2]
    del a, b
    p0 = start()
    w2, c2 = tb.walk_packed(plane, nm, pair2=True)
    lw, plain_w = stop(p0)
    ms, (w2t, c2t) = cuda_ms(lambda: tb.walk_packed(plane, nm, pair2=True), 3)
    k3_ms, (kw, kc) = cuda_ms(lambda: tb.walk_packed(plane, nm), 3)
    pw, pc, pms = walk_plain
    p0 = start()
    ow, oc = tb.walk_packed(plane[:31], nm[:31].contiguous(), pair2=True)
    lo, plain_o = stop(p0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = int(c2.sum())   # one plane byte read per move
    rec = {
        "shape": "%d x 10 kbp traced plane, %d steps" % (len(tpairs), steps),
        "ms": ms, "plain_ms": pms, "k3_ms": k3_ms,
        "max_abs_err": max(errs((w2, c2), (pw, pc)),
                           errs((w2t, c2t), (pw, pc))),
        "k3_max_abs_err": max(errs((w2, c2), (kw, kc)),
                              errs((kw, kc), (pw, pc))),
        "odd_max_abs_err": errs((ow, oc), (kw[:31], kc[:31])),
        "plan": list(_kernels.psa_walk_layout(len(tpairs), sms)),
        "thread_steps": int(c2.view(-1, 2).sum(1).max()),
        **chain_bound(int(c2.max())),
        **bound(steps + nbytes(nm, w2, c2), OPS_WALK_STEP * steps)}
    del plane, w2, c2, w2t, c2t, kw, kc, ow, oc
    # phase 6 (b)'s traced batch of 4,096 short pairs, group by group as
    # its route cuts it: the two-pair walk's path (an odd group takes K3),
    # then both walks timed (the sums over the groups), each held to phase
    # 6 (b)'s plain walks; also the sums over the groups of an even number
    # of pairs alone, those the two-pair walk takes
    pairs, groups = short_batch["pairs"], short_batch["groups"]
    planes = []
    for g in groups:
        a, b, nm = psa_diff.pack_pairs([pairs[i] for i in g], dev, traced=True)
        planes.append((psa_diff.dp_packed(a, b, nm, p, True)[2], nm))
        del a, b
    p0 = start()
    got = [tb.walk_packed(plane, nm, pair2=True) for plane, nm in planes]
    lb, plain_b = stop(p0)
    even = sum(len(g) % 2 == 0 for g in groups)
    short = {"ms_short": 0.0, "k3_ms_short": 0.0, "ms_short_even": 0.0,
             "k3_ms_short_even": 0.0, "short_max_abs_err": 0,
             "short_k3_max_abs_err": 0, "short_thread_steps": 0,
             "short_groups": []}
    for (plane, nm), (pw, pc), (gw, gc) in zip(planes, short_batch["plain"],
                                               got):
        gms, (w2t, c2t) = cuda_ms(
            lambda: tb.walk_packed(plane, nm, pair2=True), 3)
        kms, (kw, kc) = cuda_ms(lambda: tb.walk_packed(plane, nm), 3)
        short["ms_short"] += gms
        short["k3_ms_short"] += kms
        short["short_max_abs_err"] = max(short["short_max_abs_err"],
                                         errs((gw, gc), (pw, pc)),
                                         errs((w2t, c2t), (pw, pc)))
        short["short_k3_max_abs_err"] = max(short["short_k3_max_abs_err"],
                                            errs((kw, kc), (gw, gc)))
        if len(nm) % 2 == 0:   # the groups the two-pair walk takes
            short["ms_short_even"] += gms
            short["k3_ms_short_even"] += kms
            short["short_thread_steps"] = max(
                short["short_thread_steps"], int(gc.view(-1, 2).sum(1).max()))
        short["short_groups"].append(
            [len(nm), *plane.shape[1:], gms, kms,
             *_kernels.psa_walk_layout(len(nm), sms)])
    del planes, got
    rec.update(short)
    emit({"phase": "pair2_walk", "times": rec,
          "launches": {k: lw[k] for k in ("psa_walk_pair2", "psa_walk")},
          "odd_launches": {k: lo[k] for k in ("psa_walk_pair2", "psa_walk")},
          "short_launches": {k: lb[k] for k in ("psa_walk_pair2",
                                                "psa_walk")},
          "plain_calls": plain_w + plain_o + plain_b, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if (rec["max_abs_err"] or rec["k3_max_abs_err"] or rec["odd_max_abs_err"]
            or rec["short_max_abs_err"] or rec["short_k3_max_abs_err"]
            or plain_w or plain_o or plain_b or lw["psa_walk_pair2"] != 1
            or lw["psa_walk"] or lo["psa_walk"] != 1
            or lo["psa_walk_pair2"] or lb["psa_walk_pair2"] != even
            or lb["psa_walk"] != len(groups) - even or not even):
        raise AssertionError("two-pair walk: wrong result or route: %s %s %s "
                             "%s" % (rec, lw, lo, lb))
    return lw["psa_walk_pair2"], rec


def ring_phases(dev, smi_line, k1, k1_edit, traced, traced_edit):
    """Phase 19, the ring wavefront (``psa_dp.cu`` at one pair, every
    padded cell): (a) the kernel
    against its plain version on the card (best, corner, every packet) on
    the 10 kbp example, D = 8 at T = 256 and D = the SM count at T = 32,
    and at the main path's own shape: the 200 kbp pair's ``a`` (C = 1,536
    columns per shard at D = 132), T = 256, ``b`` cut to its first two row
    blocks, both timed there for the kernels record; (b) the 200 kbp pair of
    ``check_200k``'s K1 call (read 1 against read 0) through
    ``align_long_ring`` on a virtual one-card mesh of D = the SM count, T
    = 256, the launch counters and the plain calls on the card reset
    before and read after, its best and corner equal to ``k1`` (phase
    14) and to ``traced``, the maxsorce and corner of a route with its
    own body (phase 15 (c), the chunked traced DP), then 3 launches timed
    (CUDA events); (c) the same under edit scoring against ``k1_edit``
    (phase 16's K1 pass) and ``traced_edit`` (phase 16 (d)'s traced
    route); (d) D = 16 and 66 at full width, each held to ``k1``; (e) one
    shard past the card's resident limit raises, without launching.
    Returns the launches of (b) and the kernels record's timing."""
    import torch

    from tsta_tpu_torch.ops import _kernels, psa_ring
    from tsta_tpu_torch.parallel import mesh as meshlib
    p = (2, -5, -2, -4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def pair(a, b, D, T):
        a_p, b_p, n_real, m_real = psa_ring.pad_pair(a, b, D, T)
        return (torch.from_numpy(a_p).to(dev), torch.from_numpy(b_p).to(dev),
                n_real, m_real)

    # (a) kernel against plain: the example, then the main path's shape
    s1, s2 = golden_example()
    reads = long_reads(13, 200000)
    ra, rb = reads[1], reads[0]          # K1's a and b in check_200k
    cells = len(ra) * len(rb)
    recs, err = {}, 0
    for key, x, y, D, T in (("example D = 8", s1, s2, 8, 256),
                            ("example", s1, s2, sms, 32),
                            ("main", ra, rb[:512], sms, 256)):
        a, b, n_real, m_real = pair(x, y, D, T)
        ms, got = cuda_ms(lambda: psa_ring.ring_kernel(a, b, n_real, m_real,
                                                       p, D, T), 3)
        pms, want = cuda_ms(lambda: psa_ring.ring_plain(a, b, n_real, m_real,
                                                        p, D, T), 1, False)
        e = max(max_err(g, w) for g, w in zip(got, want))
        err = max(err, e)
        best, corner = got[0].amax(dim=0).tolist()
        recs[key] = {
            "shape": "%s, %d x %d bp padded to %d x %d, D = %d, C = %d, "
                     "T = %d" % ("the 200 kbp pair's a, b cut to 2 row blocks"
                                 if key == "main" else "the example", len(x),
                                 len(y), a.numel(), b.numel(), D,
                                 a.numel() // D, T),
            "ms": ms, "plain_ms": pms, "max_abs_err": e,
            "best": best, "corner": corner,
            "gcups": len(x) * len(y) / ms / 1e6,
            **score_bound(nbytes(a, b, *got), len(x) * len(y))}
    del a, b, got, want
    emit({"phase": "ring_vs_plain", "records": list(recs.values()),
          "smi": smi_line})
    if err or recs["example"]["best"] != -5 or recs["example D = 8"][
            "best"] != -5:
        raise AssertionError("psa_ring differs from its plain version or "
                             "the example's maxsorce: %s" % recs)

    # (b) the 200 kbp pair at full width through the entry point
    mesh = meshlib.make_mesh(1, sms, devices=[dev] * sms)
    torch.cuda.reset_peak_memory_stats(dev)
    p0 = start()
    t0 = time.perf_counter()
    best, corner = psa_ring.align_long_ring(ra, rb, p, mesh=mesh, T=256)
    wall = time.perf_counter() - t0
    lb, plain_b = stop(p0)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    a, b, n_real, m_real = pair(ra, rb, sms, 256)
    ms, out = cuda_ms(lambda: psa_ring.ring_kernel(a, b, n_real, m_real, p,
                                                   sms, 256)[0], 3, False)
    full = {"shape": "200 kbp pair, %d x %d bp padded to %d x %d, D = %d, "
                     "T = 256" % (len(ra), len(rb), a.numel(), b.numel(), sms),
            "ms": ms, "wall_s": wall, "gcups": cells / ms / 1e6,
            "peak_device_gb": peak, "best": best, "corner": corner,
            "timed_best_corner": out.amax(dim=0).tolist(),
            "k1": [k1["score"], k1["corner"]], "k1_s": k1["s"],
            "traced": [traced["score"], traced["corner"]],
            "rows": b.numel() + (sms - 1) * 256, "n_pad": a.numel(),
            **score_bound(nbytes(a, b, out) + 8 * sms * b.numel(), cells)}
    emit({"phase": "ring_200k", **full, "launches": lb["psa_ring"],
          "plain_calls": plain_b, "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    if ([best, corner] != full["k1"] or full["timed_best_corner"]
            != full["k1"] or full["traced"] != full["k1"]
            or lb["psa_ring"] != 1 or plain_b or sum(lb.values()) != 1):
        raise AssertionError("psa_ring at 200 kbp: (%d, %d) against K1's %s,"
                             " launches %s, plain calls %d"
                             % (best, corner, full["k1"], lb, plain_b))

    # (c) edit scoring, against phase 16's K1 pass over the pair
    p0 = start()
    t0 = time.perf_counter()
    got_edit = psa_ring.align_long_ring(ra, rb, EDIT, mesh=mesh, T=256)
    wall_c = time.perf_counter() - t0
    lc, plain_c = stop(p0)
    want_edit = (k1_edit["score"], k1_edit["corner"])
    traced_e = (traced_edit["score"], traced_edit["corner"])
    emit({"phase": "ring_200k_edit", "best_corner": got_edit,
          "k1": want_edit, "traced": traced_e, "k1_s": k1_edit["s"],
          "wall_s": wall_c, "launches": lc["psa_ring"],
          "plain_calls": plain_c})
    if (got_edit != want_edit or got_edit != traced_e or lc["psa_ring"] != 1
            or plain_c):
        raise AssertionError("psa_ring at 200 kbp, edit scoring: %s against "
                             "K1's %s" % (got_edit, want_edit))

    # (d) the shard count at full width
    sweep = {}
    for D in (16, 66):
        a, b, n_real, m_real = pair(ra, rb, D, 256)
        ms_d, out = cuda_ms(lambda: psa_ring.ring_kernel(
            a, b, n_real, m_real, p, D, 256)[0], 1, False)
        sweep[D] = {"ms": ms_d, "gcups": cells / ms_d / 1e6,
                    "columns_per_shard": a.numel() // D,
                    "best_corner": out.amax(dim=0).tolist()}
    sweep[sms] = {"ms": ms, "gcups": full["gcups"],
                  "columns_per_shard": full["n_pad"] // sms,
                  "best_corner": full["timed_best_corner"]}
    del a, b, out

    # (e) one shard past the resident limit
    limit = _kernels.psa_ring_max_blocks(128, 32, dev)
    over = meshlib.make_mesh(1, limit + 1, devices=[dev] * (limit + 1))
    p0 = start()
    t0 = time.perf_counter()
    try:
        psa_ring.align_long_ring(s1[:1000], s2[:1000], p, mesh=over, T=32)
        raised = None
    except _kernels.KernelError as exc:
        raised = str(exc)
    le, _ = stop(p0)
    over_s = time.perf_counter() - t0
    emit({"phase": "ring_sweep", "sweep": sweep, "resident_limit": limit,
          "over_limit_raised": raised, "over_limit_s": over_s,
          "over_limit_launches": le["psa_ring"], "smi": smi_line})
    if any(v["best_corner"] != full["k1"] for v in sweep.values()):
        raise AssertionError("psa_ring's D sweep disagrees with K1: %s"
                             % sweep)
    if (raised is None or "at most %d" % limit not in raised
            or le["psa_ring"]):
        raise AssertionError("psa_ring past the resident limit (%d) did not "
                             "raise its own KernelError: %s" % (limit, raised))
    rec = dict(recs["main"], max_abs_err=err, ms_200k=ms,
               bound_ms_200k=full["bound_ms"], gcups_200k=full["gcups"],
               k1_s_200k=k1["s"])
    return {"psa_ring": lb["psa_ring"]}, {"psa_ring": rec}




# phase 24 (c): one rank of the ring across processes on cuda:0, the 10
# kbp example, jax and the JAX package blocked
RING_RANK_CHILD = r"""
import json, sys, time
BLOCKED = ("jax", "jaxlib", "tsta_tpu")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("import blocked: " + name)
sys.meta_path.insert(0, _Block())
import torch
import chip_smoke
from tsta_tpu_torch import AlignParams
from tsta_tpu_torch.ops import _kernels, psa_ring, psa_scan
from tsta_tpu_torch.parallel import mesh
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.zeros(1, device=dev)
_kernels._lib()
assert mesh.maybe_init_distributed()
s1, s2 = chip_smoke.golden_example()
_kernels.reset_launches()
torch.cuda.synchronize()
t0 = time.perf_counter()
got = psa_ring.align_long_ring_ranks(s1, s2, AlignParams(), T=256, device=dev)
wall = time.perf_counter() - t0
print("RANK " + json.dumps({
    "got": list(got), "wall_s": wall,
    "launches": {k: v for k, v in _kernels.launches.items() if v},
    "plain_calls": psa_scan.plain_calls,
    "blocked_clean": not [k for k in sys.modules
                          if k.split(".")[0] in BLOCKED]}), flush=True)
"""


def ring_cards_phases(dev, smi_line, k1, ring_rec):
    """Phase 24, the ring across cards and processes (``psa_dp.cu``'s
    linked build, one launch a card, ``psa_ring.run_ring_cards``): (a)
    the kernel, K = 2 and 4 cards of ``dev`` at the cards' plan (D_k),
    against its plain version (``run_ring_cards`` over as many CPU
    devices at the same D_k), T = 256, on the 10 kbp example
    and on the 200 kbp pair's ``a`` against its first two row blocks of
    ``b`` (the main path's shape): every card's shards' best, corner and
    packets and every packet of every link; (b) the whole 200 kbp pair
    over ``[dev] * K``, K = 2 and 4, the launch counters and the plain
    calls reset before and read after: K launches, no plain call, best
    and corner equal to phase 14's K1 (``k1``) and the one-launch ring of
    phase 19; then 2 more runs, each launch timed (CUDA events); (c)
    ``align_long_ring_ranks`` as 2 processes on ``dev`` over the example,
    equal to (a); (d) a mesh of two distinct cards where the host has
    them, else a line saying it did not run.  Returns the launches of
    (b) and the kernels record."""
    import torch

    from tsta_tpu_torch.ops import psa_ring
    from tsta_tpu_torch.parallel import mesh as meshlib
    p = (2, -5, -2, -4)
    T = 256
    t_phase = time.perf_counter()

    def padded(x, y, K):
        a_p, b_p, n_real, m_real = psa_ring.pad_pair(x, y, K, T)
        return torch.from_numpy(a_p), torch.from_numpy(b_p), n_real, m_real

    # (a) kernel against plain, every packet of every link
    s1, s2 = golden_example()
    reads = long_reads(13, 200000)
    ra, rb = reads[1], reads[0]          # K1's a and b in check_200k
    recs, err = {}, 0
    for label, x, y in (("example", s1, s2), ("main", ra, rb[:512])):
        for K in (2, 4):
            a, b, n_real, m_real = padded(x, y, K)
            st = []
            got = psa_ring.run_ring_cards(a, b, n_real, m_real, p, [dev] * K,
                                          T, stats=st)
            t0 = time.perf_counter()
            want = psa_ring.run_ring_cards(a, b, n_real, m_real, p,
                                           ["cpu"] * K, T, D=got.shards)
            pms = (time.perf_counter() - t0) * 1e3
            e = max(max_err(g.cpu(), w) for g, w in zip(
                got.outs + got.comms + got.links,
                want.outs + want.comms + want.links))
            e = max(e, abs(want.best - got.best),
                    abs(want.corner - got.corner))
            err = max(err, e)
            recs["%s K = %d" % (label, K)] = {
                "shape": "%s, %d x %d bp padded to %d x %d, %d cards of %s, "
                         "D_k = %s, T = %d" % (
                             "the 200 kbp pair's a, b cut to 2 row blocks"
                             if label == "main" else "the example", len(x),
                             len(y), a.numel(), b.numel(), K, dev, got.shards,
                             T),
                "ms": sum(st[0]["ms"]), "launch_ms": st[0]["ms"],
                "plain_ms": pms, "plain_on": "cpu", "max_abs_err": e,
                "shards": got.shards,
                "best": got.best, "corner": got.corner,
                "link_packets": sum(int(lk.numel()) for lk in got.links) // 2,
                **score_bound(nbytes(a, b, *got.outs, *got.comms)
                              + 2 * nbytes(*got.links), len(x) * len(y))}
    emit({"phase": "ring_cards_vs_plain", "records": recs, "smi": smi_line})
    if err or recs["example K = 2"]["best"] != -5 or recs[
            "example K = 4"]["best"] != -5:
        raise AssertionError("the linked ring differs from its plain version "
                             "or the example's maxsorce: %s" % recs)

    # (b) the 200 kbp pair over K cards of dev
    full, launches = {}, 0
    for K in (2, 4):
        a, b, n_real, m_real = padded(ra, rb, K)
        p0 = start()
        t0 = time.perf_counter()
        st = []
        run = psa_ring.run_ring_cards(a, b, n_real, m_real, p, [dev] * K, T,
                                      stats=st)
        wall = time.perf_counter() - t0
        lb, plain_b = stop(p0)
        launches += lb["psa_ring_linked"]
        for _ in range(2):
            again = psa_ring.run_ring_cards(a, b, n_real, m_real, p,
                                            [dev] * K, T, stats=st)
        per = [statistics.median(x) for x in zip(*(s["ms"] for s in st))]
        full[K] = {"shape": "200 kbp pair, %d x %d bp padded to %d x %d, %d "
                            "cards of %s, D_k = %s, T = %d"
                            % (len(ra), len(rb), a.numel(), b.numel(), K, dev,
                               run.shards, T),
                   "launch_ms": per, "ms": sum(per), "wall_s": wall,
                   "best_corner": [run.best, run.corner],
                   "again": [again.best, again.corner],
                   "k1": [k1["score"], k1["corner"]],
                   "launches": lb["psa_ring_linked"], "plain_calls": plain_b,
                   "others": sum(v for k, v in lb.items()
                                 if k != "psa_ring_linked"),
                   "gcups": len(ra) * len(rb) / sum(per) / 1e6,
                   **score_bound(nbytes(a, b, *run.outs, *run.comms)
                                 + 2 * nbytes(*run.links),
                                 len(ra) * len(rb))}
    emit({"phase": "ring_cards_200k", "runs": full,
          "one_launch_ring_ms": ring_rec["ms_200k"], "smi": smi_line,
          "clocks_power": smi("clocks.sm,power.draw,temperature.gpu")})
    bad = {K: r for K, r in full.items()
           if r["best_corner"] != r["k1"] or r["again"] != r["k1"]
           or r["launches"] != K or r["plain_calls"] or r["others"]}
    if bad:
        raise AssertionError("the ring over cards at 200 kbp: %s" % bad)

    # (c) two processes on dev, the example
    env = dict(os.environ, TSTA_COORDINATOR="127.0.0.1:%d" % free_port(),
               TSTA_NUM_PROCESSES="2", TSTA_DIST_TIMEOUT_S="120",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", RING_RANK_CHILD],
                              cwd=ROOT, env=dict(env, TSTA_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=240))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    ranks = []
    for r, (pr, (out, er)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if pr.returncode != 0 or not lines:
            raise RuntimeError("ring rank %d failed (rc %s):\n%s"
                               % (r, pr.returncode, er[-4000:]))
        ranks.append(json.loads(lines[-1][5:]))
    want = [recs["example K = 2"]["best"], recs["example K = 2"]["corner"]]
    emit({"phase": "ring_cards_ranks", "ranks": ranks, "want": want,
          "wall_s": time.perf_counter() - t0})
    if any(rk["got"] != want or rk["launches"] != {"psa_ring_linked": 1}
           or rk["plain_calls"] or not rk["blocked_clean"] for rk in ranks):
        raise AssertionError("the ring over 2 processes: %s, want %s"
                             % (ranks, want))

    # (d) distinct cards
    if torch.cuda.device_count() >= 2:
        mesh = meshlib.make_mesh(1, 2, devices=["cuda:0", "cuda:1"])
        p0 = start()
        t0 = time.perf_counter()
        got = psa_ring.align_long_ring(ra, rb, p, mesh=mesh, T=T)
        wall = time.perf_counter() - t0
        ld, plain_d = stop(p0)
        emit({"phase": "ring_cards_distinct", "run": True,
              "best_corner": list(got), "k1": [k1["score"], k1["corner"]],
              "wall_s": wall, "launches": ld["psa_ring_linked"],
              "plain_calls": plain_d})
        if (list(got) != [k1["score"], k1["corner"]]
                or ld["psa_ring_linked"] != 2 or plain_d):
            raise AssertionError("the ring over two distinct cards: %s" % got)
    else:
        emit({"phase": "ring_cards_distinct", "run": False,
              "reason": "%d card visible: distinct cards not run"
                        % torch.cuda.device_count()})
    emit({"phase": "ring_cards_done", "phase_s": time.perf_counter() - t_phase})
    rec = dict(recs["main K = 2"], max_abs_err=err, ms_200k=full[2]["ms"],
               bound_ms_200k=full[2]["bound_ms"], gcups_200k=full[2]["gcups"],
               ms_200k_4=full[4]["ms"], k1_s_200k=k1["s"])
    return {"psa_ring_linked": launches}, {"psa_ring_linked": rec}

def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(nproc: int) -> list:
    """Phase 23 (c): ``RANK_CHILD`` as ``nproc`` processes joined over
    gloo on loopback; each rank's record, in rank order.  Raises if a
    rank fails."""
    env = dict(os.environ, TSTA_COORDINATOR="127.0.0.1:%d" % free_port(),
               TSTA_NUM_PROCESSES=str(nproc), TSTA_DIST_TIMEOUT_S="180",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CHILD], cwd=ROOT,
                              env=dict(env, TSTA_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError("rank %d of %d failed (rc %s):\n%s"
                               % (r, nproc, p.returncode, err[-4000:]))
        recs.append(json.loads(lines[-1][5:]))
    return recs


def mesh_round_bound(st, word_bytes: int) -> dict:
    """The least time of one wavefront round's cells: each window's (N, C)
    words written and its tables read once, and the single call's
    operations over the round's columns."""
    n, K, nodes = st["n"], st["K"], st["nodes"]
    tables = K * (st["NC"] * st["chunks"]) * (8 * st["max_in"] + 20)
    words = (st["NC"] * st["chunks"]) * n * word_bytes
    ops = n * (OPS_POA_PRED * st["preds_in"]
               + (OPS_POA_CELL + OPS_POA_WORD) * nodes)
    return bound(tables + words + 12 * nodes * K, ops)


def mesh_phases(dev, smi_line, res_50k, score_batch, traced_batch):
    """Phase 23: the meshes on one card, each path byte-equal to the
    meshless run; fails on a difference, a kernel not launched a window or
    a share, or a plain call."""
    import numpy as np
    import torch

    from tsta_tpu_torch import AlignParams
    from tsta_tpu_torch.ops import _kernels, msa_native
    from tsta_tpu_torch.parallel import batch as pbatch
    from tsta_tpu_torch.parallel import mesh as meshlib
    params = AlignParams()
    seqs = long_reads()
    want = msa_digest(res_50k)
    t_phase = time.perf_counter()
    bad = []

    def timed(fn):
        with counting_plain() as calls:
            p0 = start()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched, psa_plain = stop(p0)
        return out, {"wall_s": wall,
                     "launches": {k: v for k, v in launched.items() if v},
                     "plain_calls": psa_plain + sum(calls.values()),
                     "peak_device_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9}

    # (a) a one-card seq axis: the single launch at D = K
    one_card = {}
    for K in MESH_ONE_CARD_K:
        mesh = meshlib.make_mesh(1, K, devices=[dev] * K)
        out, rec = timed(lambda: msa_native.align_seqs(seqs, params,
                                                       mesh=mesh))
        rec["equal"] = msa_digest(out) == want
        one_card[K] = rec
        if (not rec["equal"] or rec["plain_calls"]
                or rec["launches"] != {"poa_dp": 2, "poa_walk": 2}):
            bad.append(("one card", K, rec))

    # (b) first the wavefront's cells and walks against their plain
    # versions on the card: phase 7's first grown graph over 3 windows of
    # 512-row chunks, every window's words, scores, ring and left edges
    from tsta_tpu_torch.models.poa_graph import PoaGraph
    from tsta_tpu_torch.ops import msa_poa
    from tsta_tpu_torch.parallel import msa_longseq
    reads = grown_reads(1)
    g = PoaGraph.from_sequence(reads[0], len(reads))
    for sno in (1, 2):
        packed, order, _ = msa_poa.run_round(g, reads[sno], params, dev,
                                             "cuda", 1 << 34)
        msa_native._finish_round(g, reads[sno], sno, order,
                                 packed.cpu().numpy(), [], [], [])
    fw = {}
    for kern in (True, False):
        _kernels.reset_launches()
        fw[kern] = msa_longseq._Forward(
            g, reads[3], params, [dev] * 3, msa_longseq.LocalLink(), kern,
            None, 512)
        torch.cuda.synchronize()
        if kern:
            cell_launches = {k: v for k, v in _kernels.launches.items() if v}
    cell_err = max(
        max_err(torch.from_numpy(fw[True].sink), torch.from_numpy(
            fw[False].sink)),
        *(max_err(getattr(fw[True].wins[d], k), getattr(fw[False].wins[d], k))
          for d in fw[True].wins for k in ("words", "scores", "ring")),
        *(max_err(fw[True].wins[d].left, fw[False].wins[d].left)
          for d in fw[True].wins if d))
    kst, pst = [], []
    kpk, _ = msa_longseq.wavefront_round(g, reads[3], params, [dev] * 3,
                                         rows_per_chunk=512, stats=kst)
    ppk, _ = msa_longseq.wavefront_round(g, reads[3], params, [dev] * 3,
                                         use_kernel=False,
                                         rows_per_chunk=512, stats=pst)
    cell_err = max(cell_err, int(not np.array_equal(kpk, ppk)))
    cell_rec = {"max_abs_err": cell_err, "launches": cell_launches,
             "shape": "%d nodes, %d windows of %d columns, %d chunks" % (
                 kst[0]["nodes"], kst[0]["active"], kst[0]["C"],
                 kst[0]["chunks"]),
             "ms": sum(w["dp_ms"] for w in kst[0]["windows"].values()),
             "plain_ms": sum(w["dp_ms"] for w in pst[0]["windows"].values()),
             "walk_ms": sum(w["walk_ms"] or 0
                            for w in kst[0]["windows"].values()),
             "walk_plain_ms": sum(w["walk_ms"] or 0
                                  for w in pst[0]["windows"].values())}
    del fw
    if cell_err or cell_launches.get("poa_dp_window", 0) != (
            kst[0]["active"] * kst[0]["chunks"]):
        bad.append(("cells against plain", cell_rec))

    # (b) then at the main path's shape: round 2 of the 3 x 50 kbp reads
    # over two windows of 24,576 columns, each cell a cooperative launch
    # of 12 shards, against the plain forward on the card
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    packed, order, _ = msa_poa.run_round(g, seqs[1], params, dev, "cuda",
                                         1 << 34)
    msa_native._finish_round(g, seqs[1], 1, order, packed.cpu().numpy(),
                             [], [], [])
    fw = {}
    for kern in (True, False):
        _kernels.reset_launches()
        fw[kern] = msa_longseq._Forward(
            g, seqs[2], params, [dev] * 2, msa_longseq.LocalLink(), kern,
            None, None)
        torch.cuda.synchronize()
        if kern:
            big_launches = {k: v for k, v in _kernels.launches.items() if v}
    fk = fw[True]
    big_err = max(
        max_err(torch.from_numpy(fk.sink), torch.from_numpy(fw[False].sink)),
        *(max_err(getattr(fk.wins[d], k), getattr(fw[False].wins[d], k))
          for d in fk.wins for k in ("words", "scores", "ring")),
        *(max_err(fk.wins[d].left, fw[False].wins[d].left)
          for d in fk.wins if d))
    big_rec = {"max_abs_err": big_err, "launches": big_launches,
               "shape": "%d nodes, %d windows of %d columns, %d chunks of "
                        "%d rows, %d shards a cell" % (
                            fk.prep[4], fk.A, fk.C, fk.nchunks, fk.NC,
                            _kernels.poa_plan(fk.C)[0]),
               "ms": sum(w.timer.ms("dp") for w in fk.wins.values()),
               "plain_ms": sum(w.timer.ms("dp")
                               for w in fw[False].wins.values())}
    big_cells = fk.A * fk.nchunks
    del fw, fk
    torch.cuda.empty_cache()
    if big_err or big_launches != {"poa_dp_window": big_cells}:
        bad.append(("50 kbp cells against plain", big_rec))

    # (b) then the 3 x 50 kbp reads over the card repeated
    windows, bounds = {}, {}
    for K in MESH_WINDOWS:
        link = msa_longseq.LocalLink([dev] * K)
        stats = []
        out, rec = timed(lambda: msa_native.align_seqs(
            seqs, params, link=link, stats=stats))
        rec["equal"] = msa_digest(out) == want
        rec["rounds"] = [{k: st[k] for k in ("n", "C", "active", "NC",
                                             "chunks", "nodes", "dp_wall_s",
                                             "walk_wall_s", "windows")}
                         for st in stats]
        cells = sum(st["active"] * st["chunks"] for st in stats)
        walks = sum(len([w for w in st["windows"].values()
                         if w["walk_ms"] is not None]) for st in stats)
        st = stats[-1]
        bounds[K] = {
            "cells_ms": sum(w["dp_ms"] for w in st["windows"].values()),
            "walks_ms": sum(w["walk_ms"] or 0
                            for w in st["windows"].values()),
            "walk_moves": sum(w["walk_counts"][0] for w in
                              st["windows"].values() if w["walk_counts"]),
            **mesh_round_bound(st, 2),
            # a move's word, a pred move's pred: the walks' one chain
            **chain_bound(sum(w["walk_counts"][0] + w["walk_counts"][1]
                              for w in st["windows"].values()
                              if w["walk_counts"]))}
        windows[K] = rec
        if (not rec["equal"] or rec["plain_calls"]
                or rec["launches"].get("poa_dp_window") != cells
                or rec["launches"].get("poa_walk_bounded") != walks
                or set(rec["launches"]) != {"poa_dp_window",
                                            "poa_walk_bounded"}):
            bad.append(("wavefront", K, rec["launches"], cells, walks))

    # (c) one window a process, the processes on cuda:0 over gloo
    ranks = {}
    for P in MESH_RANKS:
        t0 = time.perf_counter()
        recs = run_ranks(P)
        ranks[P] = {"wall_s": time.perf_counter() - t0, "ranks": recs}
        for r in recs:
            # the cells and walks of the rank's own window, each round
            mine = [w for rnd in r["windows"] for w in rnd.values()]
            launches = {k: v for k, v in (
                ("poa_dp_window", sum(w["cells"] for w in mine)),
                ("poa_walk_bounded", sum(w["walk_ms"] is not None
                                         for w in mine))) if v}
            if (r["digest"] != want or r["plain_rounds"]
                    or any(r["plain_calls"].values())
                    or r["psa_plain_calls"] or not r["blocked_clean"]
                    or len(r["windows"]) != len(seqs) - 1
                    or not launches.get("poa_dp_window")
                    or r["launches"] != launches):
                bad.append(("ranks", P, r["rank"], r["digest"],
                            r["launches"], launches))

    # (d) the batches shared over the data axis
    mesh = meshlib.make_mesh(MESH_DATA, 1, devices=[dev] * MESH_DATA)
    pairs, res = score_batch
    tpairs, tres = traced_batch
    got, score_rec = timed(lambda: pbatch.align_batch(pairs, params,
                                                      mesh=mesh))
    score_rec["equal"] = [(r.score, r.last) for r in got] == [
        (r.score, r.last) for r in res]
    got, traced_rec = timed(lambda: pbatch.align_batch_traced_device(
        tpairs, params, mesh=mesh))
    traced_rec["equal"] = got == tres
    if (not score_rec["equal"] or score_rec["plain_calls"]
            or score_rec["launches"] != {"psa_dp_score": MESH_DATA}):
        bad.append(("score batch", score_rec))
    if (not traced_rec["equal"] or traced_rec["plain_calls"]
            or min(traced_rec["launches"].get(k, 0)
                   for k in ("psa_dp_traced", "psa_walk")) < MESH_DATA):
        bad.append(("traced batch", traced_rec))

    # (e) the budget variable chunks the rounds, the profile prints
    saved = {k: os.environ.get(k) for k in ("TSTA_HBM_BUDGET_GB",
                                            "TSTA_POA_PROFILE")}
    os.environ.update(TSTA_HBM_BUDGET_GB=MESH_BUDGET_GB, TSTA_POA_PROFILE="1")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out, budget_rec = timed(lambda: msa_native.align_seqs(
                seqs, params, device=dev))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    profile = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("[poa_chunked]")]
    budget_rec.update(equal=msa_digest(out) == want, profile=profile)
    if (not budget_rec["equal"] or budget_rec["plain_calls"]
            or len(profile) != 4 or not all(
                budget_rec["launches"].get(k) for k in CHUNK_KERNELS)):
        bad.append(("budget", budget_rec))

    emit({"phase": "mesh", "smi": smi_line, "one_card": one_card,
          "cells_vs_plain": cell_rec, "cells_vs_plain_50k": big_rec,
          "wavefront": windows,
          "round2_bounds": bounds, "ranks": ranks, "score_batch": score_rec,
          "traced_batch": traced_rec, "budget": budget_rec,
          "phase_s": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError("phase 23 (meshes) failed: %s" % bad)


if __name__ == "__main__":
    sys.exit(main())
