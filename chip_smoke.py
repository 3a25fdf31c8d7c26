#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line per row:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc (one process per source, all at once) into ``build/``;
   each kernel's registers and spills (``ptxas -v``) and its count of
   tensor-core instructions (HGMMA, DMMA) in its SASS (``cuobjdump``).
2. ``kernels`` — each kernel against its plain PyTorch version on the same
   CUDA inputs (capacity bucket 1024 with m = 1000 and m = 300 for the
   KPCA kernels, the fused pair with deflated columns under a permuted
   cid; n = 4096 rows of width 512 and 200 for ``scaled_gram``; f32 and
   f64; ``rbf_gram`` at the roofline's 1024 x 1024, d = 64 in f32 and f64,
   the Fig. 2 data's full 4096 x 4096 gram, d = 10, in f64 and the ragged
   1000 x 300, d = 16 and 130 x 129, d = 3 in f32; ``flash_attention``
   at the LM prefill's B = 1, T = 4096, 64 q heads over 8 kv heads,
   hd = 128 in bf16, at DBRX's 48 over 8 (a group of 6), at MiniCPM-2B's
   training shape (B = 4, T = 2048, 36 / 36 heads of 64), at T = 1000
   (not a multiple of the tile) and at
   B = 2, T = 2048, 16 / 4 heads, hd = 64 in bf16, and at a small f32
   shape; the bf16 forward as a training step calls it (variant "lse":
   the output and each row's log-sum-exp, ``FLASH_LSE_SHAPES``:
   MiniCPM-2B's step and T = 1000); its backward ``flash_attention_bwd``
   (bf16: three kernels on ``wgmma`` and TMA reading the forward's
   log-sum-exp; f32: two SIMT kernels) at MiniCPM-2B's training shape in
   bf16 and f32, at DBRX's 48 / 8 heads of 128, at T = 1000 and at a
   small f32 GQA shape; ``ssd_intra_chunk`` at the prefill's 16 chunks of
   256, N = 128, 256 heads of 64 with bf16 x and f32 cum, and at a small
   f32 shape; its backward ``ssd_intra_chunk_bwd`` (three SIMT kernels,
   f32 sums, no atomics) at Jamba's training shape (the prefill's, bf16),
   at two chunks of 256 with 20 heads in bf16 and f32, at Q = 100 (off
   the 64-row tile, variant "Q 100") in both, at the smoke shape (8
   chunks of 8, f32) and at steep decays (variants "steep 1.0", bf16, and
   "steep 200", f32: every gradient finite)), each output entry within its own bound as
   ``repro_torch.kernels.checks`` states it, pruned entries exact zeros
   and two runs of the kernel bit for bit equal; ``eigvec_rotate``,
   ``eigvec_rotate2``, ``eigvec_project`` and ``krow_project`` also on a
   row block (rows 256:768 of the bucket), ``eigvec_rotate2`` on rows
   m:1024 (wholly past the active rows: exact zeros), ``krow_project``
   without aux columns, and ``transform_project`` at 20 components, at
   the roofline's 512 queries of 64, at one component (the KRR predict
   head) and at C = M = 512 on a capacity-512 snapshot of 500 landmarks
   (the Nyström feature head), f32 and f64, each its own ``variant`` row.  Each
   f32 row of ``eigvec_rotate`` and ``scaled_gram`` (TF32 products on the
   tensor cores) and of ``rbf_gram`` (FMAs on the CUDA cores) also holds
   the kernel's largest error against the f64 product of the same
   operands to ``TF32_ERR_RATIO`` times the plain f32 version's, and
   ``scaled_gram``'s K̃ and ``rbf_gram``'s k(X, X) must equal their
   transposes bit for bit (one triangle computed, the other mirrored;
   f64 on DMMA).  ``ssd_intra_chunk`` in
   bf16 runs on ``wgmma`` (scores once per 64-row tile, shared by a group
   of 16 heads), in f32 on the CUDA cores.  A row's ``n`` and ``m`` are
   T and H for the LM kernels (G·Q and H for the intra-chunk term).
   Then the five KPCA kernels over a tenant axis (``checks.batched_cases``:
   B = 8 tenants at bucket 1024, tenant b at m = 300 + 100 b with its own
   operands, f32 and f64; variant "B 8"): one launch against the batched
   plain version within the same bounds, each tenant bit for bit the
   single launch on its operands, two runs bit for bit.
3. ``service`` — the KPCA service, ``repro_torch.launch.serve --mode
   kpca`` (Algorithm 2, fused k-row prologue, bucketed dispatch), on the
   sequential route (``--matmul pallas``) and on the fused-pair route
   (``--matmul pallas2``): capacity 1024, d = 16, 4 seed + 600 streamed
   points in f32 (m = 604 runs the 1024 bucket), a batch of 64 queries
   every 16 points; then capacity
   256 with 200 points in f64.  Every kernel's launch count is reset just
   before each run and read just after, and must match the reckoning
   (sequential: 4 rotations per point; fused: rotate2 + rotate / 2 = 2
   pairs per point, a pair whose cluster merge fires running as two
   rotations; both: 1 k-row pass and 1 projection per point, 1 transform
   per query batch).  The final state is held against ``batch_kpca``
   (eigh on the card, f64).
4. ``nystrom`` — the landmark service, ``serve --mode nystrom`` (paper §4,
   grow_rows, append policy, Algorithm 1 per admission on the fused-pair
   route): capacity 512, d = 16, 1000 points, f32 and f64.  Its final
   ``trace_error`` is held against an f64 recomputation from the dense
   gram on the card, its pseudo-inverse cut alike, its eigensystem against
   eigh of the landmarks' gram (the KPCA bars), and its launches to the
   reckoning (1 k-row pass and 1 pair per admission).
5. ``fig2``    — the paper's Fig. 2 loop: ``magic_like`` with n = 4096
   rows (d = 10, standardised, RBF with sigma from the median heuristic,
   f64, fixed rows), 16 seed landmarks grown by ``Engine.add_landmark``
   to 512; at m = 64, 128, 256 and 512, K̃ from ``scaled_gram`` against
   the plain (B·s) @ Bᵀ entry by entry, the trace norm of K - K̃ from
   ``approximation_error`` against ``trace_error`` (K - K̃ is PSD: the
   same quantity), and the trace error non-increasing (nested sets).
6. ``window`` — the sliding-window service, ``serve --mode kpca --window
   W``: f32 on the sequential route at capacity 1024, W = 600, d = 16,
   4 seed + 700 points (104 steady-state evict + ingest steps in the
   1024 bucket), queries of 64 every 16 points; f64 on the fused-pair
   route at capacity 256, W = 200, 4 + 300 points.  Launches against the
   reckoning (a growth point as in the service; a steady-state point adds
   the downdate's two inverse pairs: 8 rotations on the sequential route),
   the state's rows exactly the last W streamed points in arrival order
   with consecutive ages, the eigensystem against eigh of those W points,
   and the update latency split into growth and steady state.
7. ``lifecycle`` — ``serve --mode nystrom --landmark-policy leverage``
   (grow_rows, d = 16, RBF sigma = 16): f32 at capacity 512, budget 256,
   2000 points, the stopping rule at its defaults; f64 at capacity 256,
   budget 128, 1000 points, ``--stop-rel-tol 0``.  Every point accounted
   for (admitted + replaced + rejected), launches to the reckoning, the
   final trace error against the f64 recomputation (the Nyström bars),
   the eigensystem against eigh, and the synchronizing operations inside
   each offer (torch's sync debug mode) by action.  ``lifecycle_swaps``:
   the leverage arm does not fire on an i.i.d. stream, so the replacement
   path is driven at the f64 shape (124 admissions to the budget of 128,
   then 200 swaps of the lowest-leverage landmark through
   ``Engine.replace_landmark``, the tracker fed each swap delta): the
   tracked and final trace errors against f64, the eigensystem against
   eigh, and a donating swap equal to the copying one on its own storage.
8. ``truncate`` — the f32 ``pallas`` Algorithm-2 service at capacity 1024,
   600 points, then ``truncate(64)`` compacted and uncompacted, and the
   uncompacted one also under fixed dispatch, then 150 points each (100
   under fixed dispatch):
   64 active, orthonormal kept columns, finite; uncompacted, the kept
   eigenvalues the 64 largest bit for bit and the stream equal to fixed
   dispatch within the f32 eigenvalue bar (the row-support floor); the
   top-3 eigenvalues against eigh reported.
9. ``krr`` — ``core/krr.py`` in f64 at capacity 1024, 700 points,
   lambda = 0.1: α against a dense solve on the card, 256 held-out
   predictions through the published head (``transform_project`` at
   C = 1) against ``predict``, LOOCV residuals against 128 refits.
10. ``snapshots`` — a ``DoubleBuffer`` over the f32 service at capacity
   1024, C = 8: the front bit for bit the same through 64 ingests,
   generations 0..3, the third publish in the first's storage, the
   retired snapshot untouched, ``query_batch`` over 4 stacked snapshots
   against 4 queries bit for bit, and the Nyström feature head at
   C = M = 512 (the f32 Nyström phase's state) against
   ``query_features``.
11. ``reproducible`` — two runs of one f32 ``pallas`` stream (capacity
   1024, 48 points) from one state, bit for bit equal with torch's
   deterministic mode off (the cluster merge's segment sums add in a
   fixed order), and a guarded run with and without the metric lane
   (every 12th point non-finite).
12. ``health`` — ``serve --mode kpca --health --metrics`` (f32 ``pallas``,
   capacity 1024, 4 + 600 points) with a NaN or inf point every 97th,
   U tilted off orthogonality (into the polish band) before point 150
   and an eigenvalue negated before point 350: each rejected point
   leaves the state bit for bit, the quarantine count is the injected
   count, each corruption is flagged within ⌈m/B⌉ probes, the heals (at
   the transform interval) polish the tilt and resync the negated
   eigenvalue, the readings each heal saw lie on the rule's side of the
   policy's thresholds (a check of the port against its policy: the
   rule itself is held against the JAX package on the CPU), the
   final state holds the f32 eigh bars, the metric counters equal a host
   tally, the launches are the unguarded route's for every offered point
   (a rejected point runs its update on a stand-in), and the synchronizing
   calls per guarded update, per rejected point and per heal are counted.
   ``restore``: a poisoned stored row makes the heal raise
   ``HealthError``; the last checkpoint (``checkpoint.npz_store``, in a
   temporary directory) loads, the replayed tail equals the uninterrupted
   run bit for bit.  ``health_window``: ``--window 200 --health`` in f64
   on the fused pair (capacity 256, 264 points, every 29th poisoned):
   rejected points leave the ring and the clock untouched, the window
   holds the last W accepted points.  ``health_nystrom``: ``--mode
   nystrom --health`` (f32, capacity 256, 500 points, every 50th
   poisoned): the rows are dropped, the trace error holds its bar.
12b. ``multitenant`` — ``serve --mode kpca --tenants 8 --cohorts max``
   (f32 ``pallas``, the fused prologue, bucketed, capacity 1024, d = 16,
   4 + 600 points a tenant, 64 queries x 8 components every 16 points):
   each kernel launched once a step for the cohort (the single stream's
   reckoning), synchronizing calls inside a step only at bucket
   crossings, every tenant's top-8 against f64 eigh (the f32 bars); then
   the same stream at B = 1 and B = 8 for 10 steps at the top bucket:
   kernel launches per step equal, device launches within 10 %, no
   synchronizing call, aggregate updates/s of both.
   ``multitenant_cohorts``: f64 ``pallas2``, capacity 256, B = 6, the
   ``bucket`` and ``bucket-padded`` geometries under a mask spreading the
   tenants, then a 6-step block: more than one group, every tenant equal
   to its own single stream on the card (1e-9 / 1e-8), idle tenants bit
   for bit.  ``multitenant_window``: ``--tenants 4 --window 200 --health
   --metrics`` (f64 ``pallas``, capacity 256, 264 points), cohorts
   ``max`` and ``bucket``, two non-finite points injected into two lanes:
   the rejected lane bit for bit, the others advance, each tenant's rows
   its last W accepted points, f64 eigh bars, tallies and metric lanes
   equal to a host tally.
12c. ``decoupled`` — ``serve --mode kpca --decouple`` (``IngestServeLoop``)
   at full width: 8 tenants, capacity 1024, f32 ``pallas``, d = 16, 4 +
   600 points, 2 batches of 64 queries a step, republished every 4 steps,
   ``--health``: 150 generations, every answer bit for bit
   ``serving.query_batch`` on the snapshot it read, every tenant's top-8
   against f64 eigh, launches to the reckoning; ingest, query and publish
   p50/p99.  A ``--publish-on-drift 0.05 --drift-probe-every 4
   --serve-every 64`` run (200 points): the probes equal the loop's rule
   for the publications that happened.  A fault run through ``on_step``:
   a tilted tenant healed and published, a tenant poisoned beyond repair
   refusing every later publication, the answers the frozen snapshot's.
12d. ``sharded`` — ``core/distributed``'s builders at P = 1 over NCCL in
   this process: 100 sharded updates (``pallas``) and 100 pairs
   (``pallas2``) from the multitenant phase's tenant 0 (m = 604), an f32
   ``pallas`` window block (capacity 1024, W = 1000, 100 steps, the fused
   k-row ingest), an f64 ``pallas2`` guarded window block (capacity 256,
   W = 200, 50 steps, every 10th point poisoned), a block of poison, and
   ``serve --decouple --mesh 1x1``: f32 against f64 eigh at the service
   bars, the f64 block against the local ``Engine`` path (1e-10 of
   λmax), a poisoned block bit for bit, each rank's launches to the
   reckoning.  ``sharded_p2``: the same jobs on two gloo ranks on the one
   card (``testing/spmd``; gloo stages CUDA tensors through the host),
   rank 1 at row offset 512 (128 at capacity 256), ``--mesh 2x1`` whose
   answers are held to the one-process run's for the same tenants.
13. ``roofline`` — ``repro_torch.launch.roofline`` at the reference
   driver's shapes: a STREAM triad on the card, one row per kernel with
   its rate against it, and the fused-against-unfused ingest and query
   (16 components).  It is ``rbf_gram``'s path: the kernels' launches
   are counted around it and held to ``roofline.launch_reckoning`` (one
   a call; C = 64 is one ``transform_project`` launch).
14. ``lm_moe`` — DBRX-132B at its full widths (d_model 6144, 48 q / 8 kv
   heads of 128, 16 experts top-4 of width 10752, vocab 100352), cut to 4
   of its 40 layers (14.3 B parameters, 26.6 GiB bf16 drawn on the card):
   the prefill at B = 1, T = 4096 (3 warm-up and 10 timed calls, one
   ``flash_attention`` launch a layer), the routing of one such prefill
   (dropped share, tokens per expert), prefill against teacher-forced
   decode over 256 tokens from caches built at 256 (so decode's capacity
   is the prefill's) with both runs' routes recorded (``recorded_routes``
   wraps the router and the slot positions for the duration): the share
   of (token, layer, k) choices that agree, overall and up to each
   position's first differing layer (the latter at least
   ``ROUTE_AGREEMENT``), the positions routed otherwise counted, the
   others' logits within ``LM_MOE_BAR``; then ``lm_main`` as ``serve
   --mode lm`` runs it (batch 4, prompt 16, gen 32).  ``lm_xlstm``:
   xLSTM-125m whole (10 mLSTM + 2 sLSTM layers, bf16; no kernel, every
   launch count 0): the prefill (1 + 3 calls), prefill against decode
   reported beside ``LM_XLSTM_BAR``, each block kind's parallel form
   against its recurrence within ``LM_XLSTM_BLOCK_BAR``, ``serve --mode
   lm``.  ``lm``: the same path at the full width of Jamba-1.5-Large, one
   period (8 layers: 7 mamba + 1 attention) with ``moe=None`` (every layer
   its dense FFN: 8.9 B parameters, 16.6 GiB bf16; its experts would make
   84 GiB): prefill timed, launches held to the reckoning (1
   ``flash_attention`` and 7 ``ssd_intra_chunk`` per forward), the forward
   over a 256-token prompt against ``decode_step`` teacher-forced over
   the same tokens (no kernel launch), logits finite and within
   ``LM_BAR``, ``serve --mode lm``.
14b. ``lm_train`` — MiniCPM-2B trained whole on the card (40 layers,
   d_model 2304, 36 heads of 64, d_ff 5760, vocab 122753, tied
   embeddings, residual scale 1.4/√40; 2.72 B parameters in bf16 drawn
   from seed 0): 4 steps of ``make_train_step`` (AdamW, f32 moments, the
   WSD schedule, clipping to norm 1, remat per layer) on ``TokenStream``
   batches of B = 4, T = 2048.  Its memory is reckoned and printed before
   it runs (``train_reckoning``), the peak printed beside it; each step's
   loss, gradient norm and rate, finite; ``flash_attention`` 80 and
   ``flash_attention_bwd`` 40 launches a step (forward and recompute per
   layer, one backward per layer); step ms p50, tokens/s, the model-FLOP
   share of the bf16 dense peak; then two steps from seed 0 twice: the
   gradient norms and the parameters bit for bit.  ``lm_train_jamba``:
   Jamba-1.5-Large at every published width (d_model 8192, 64 q / 8 kv
   heads of 128, d_ff 24576, vocab 65536, Mamba N = 128, 256 heads of 64,
   chunk 256), the first four layers of its period (mamba ×3, attn) with
   ``moe=None``: 4.86 B bf16 parameters drawn on the card, 4 AdamW steps
   (cosine schedule, clipping, remat per period) on B = 1, T = 4096, the
   same checks and rows as ``lm_train``; a step launches
   ``ssd_intra_chunk`` 6 times (forward and recompute), its backward 3,
   ``flash_attention`` 2 and its backward 1.  ``lm_train_check``: one
   step of MiniCPM-2B's smoke config (f32) and of Jamba's smoke cut (a
   Mamba layer, then attention with the experts; B 2, T 64 in 8 chunks)
   on the card against the CPU from the same weights: the experts' routes
   alike, the loss, every gradient leaf and the parameters after one
   AdamW step within the bounds its docstring derives.  ``lm_nystrom``: a
   2-layer dense config at MiniCPM's widths
   with Nyström attention (f32, 256 landmarks set to each layer's keys of
   a 256-token prompt): prefill against teacher-forced decode within
   ``NYSTROM_BAR``; then ``grow_landmark`` 64 times on the card (f64,
   two ``eigvec_rotate`` launches a landmark), its eigenvalues within
   ``GROW_BAR`` of f64 eigh of the grown gram.  The serving LM phases
   (``lm_moe``, ``lm_xlstm``, ``lm``, ``lm_profile``) run under
   ``torch.inference_mode``.
15. ``timing`` — at the kernel phase's shapes that PERF.md's kernel
   table reads (``timed_row``: each kernel's main-path shape in both
   types and the table's variants; the others are checked, not timed),
   each kernel's device time (profiler records over 25 calls; where the
   profiler records nothing, CUDA events around calls queued behind a
   spin kernel) beside the plain version's (5 calls), one library call's
   and its bound, and each call's event-timed time, host work included;
   each batched kernel's beside the 8 single launches' (``singles_ms``,
   10 calls each).  It runs after the services so that the profiler is
   never attached to one.
16. ``lm_profile`` — one prefill of the ``lm`` phase under the profiler:
   device time by kernel group (the two LM kernels, cuBLAS's matmuls, the
   rest) and the idle share.  It runs last: on one H100 host the
   profiler recorded no device activity after a prefill had been profiled.

Each of the previously unsplit phases (build, kernels, the batched
kernels, roofline, timing, batched timing, lm_profile) closes with a
``total_s``; ``main`` clocks every phase whole and prints the ``wall``
row (seconds by phase and in all).  Then the card's name and power
limit, the kernels' summary line (rows 1-5
with a ``batched`` entry: the B = 8 launch's time, its singles' time, its
launches on the multi-tenant paths), and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_N, MAIN_M = 1024, 1000
# The tenant axis: B = 8 tenants at bucket 1024, tenant b at m = 300 + 100 b.
TENANTS = 8
TENANT_MS = tuple(range(300, 1001, 100))
FEATURES = (512, 500)      # transform_project as the Nyström feature head
GRAM_N, GRAM_K = 4096, (512, 200)   # scaled_gram: Fig. 2 rows, widths
# rbf_gram (n, m, d, dtype): the roofline's gram in both types first (its
# f32 row is the kernel's main-path row), then ragged edges.  Fig. 2's
# full gram is added from the magic_like data.
RBF_SHAPES = ((1024, 1024, 64, "float32"), (1024, 1024, 64, "float64"),
              (1000, 300, 16, "float32"), (130, 129, 3, "float32"))
# Final-state bars against the eigh oracle (top-8 eigenvalues' largest
# relative error, smallest cosine of the principal angles between the
# top-8 subspaces).  On this data the port's stream, run on a CPU, is
# 3.4e-6 / 1 - 2.8e-6 off in f32 at 250 points and 1.3e-8 / 1 - 1e-12 in
# f64; the bars leave room for the drift of a 4x longer stream and a
# top-8 gap of 1.4 % (f32), and sit far below a wrong rotation (errors of
# order 1).  The reference's f32 stream is 2.2e-2 off at 250 points: its
# displacement deflation uses the state type's eps (ROADMAP.md, "Faults
# found"); the port uses the solve type's.
BARS = {"float32": (1e-3, 0.999), "float64": (1e-6, 1.0 - 1e-8)}
# Nyström service: final trace_error's relative error against the f64
# recomputation cut where the run cuts its pseudo-inverse.  f64 keeps the
# 1e-6 of the plan (1.5e-13 on an H100).  In f32 the gap is the streamed
# eigensystem's: 507 updates leave each eigenvalue ~2e-5·λmax off (the
# smallest, 0.034, by 6 %), and K_mm's pseudo-inverse carries that into
# the trace error: 1.8e-3 to 2.7e-3 off in eight runs on an H100 (its f32
# sums vary from run to run), while eigh of the same f32 gram is 2.5e-5
# off and no eigenvalue lies between the two types' cuts (PERF.md,
# Findings PR 13).  So f32 is held to 5e-3, and its eigensystem to the
# KPCA bars above.
NYSTROM_BARS = {"float32": 5e-3, "float64": 1e-6}
FIG2_REL = 1e-8          # approximation_error's trace vs trace_error
# The LM kernels (B, T, H, Hkv, hd) and (G, Q, N, H, P) with their types:
# the prefill's shape first (its row is the kernel's main-path row), then
# the others.
FLASH_SHAPES = (((1, 4096, 64, 8, 128), "bfloat16"),
                ((1, 4096, 48, 8, 128), "bfloat16"),     # DBRX's prefill
                ((4, 2048, 36, 36, 64), "bfloat16"),     # MiniCPM's step
                ((1, 1000, 8, 2, 128), "bfloat16"),
                ((2, 2048, 16, 4, 64), "bfloat16"),
                ((2, 256, 4, 2, 64), "float32"))
# The flash_attention backward: MiniCPM-2B's training shape (B 4, T 2048,
# 36 / 36 heads of 64) first (its row is the kernel's main-path row), in
# bf16 and f32, DBRX's 48 / 8 heads of 128, T = 1000 (not a multiple of
# the 64-row tile) and a small f32 GQA shape.
FLASH_BWD_SHAPES = (((4, 2048, 36, 36, 64), "bfloat16"),
                    ((1, 4096, 48, 8, 128), "bfloat16"),
                    ((4, 2048, 36, 36, 64), "float32"),
                    ((1, 1000, 8, 2, 128), "bfloat16"),
                    ((2, 300, 4, 2, 48), "float32"))
# The bf16 forward as a training step calls it (variant "lse": the output
# and each row's log-sum-exp, which the backward reads): MiniCPM-2B's step
# (timed beside the prefill's rows) and a T that is no multiple of 64.
FLASH_LSE_SHAPES = ((4, 2048, 36, 36, 64), (1, 1000, 8, 2, 128))
SSD_SHAPES = (((16, 256, 128, 256, 64), "bfloat16"),
              ((3, 32, 16, 4, 8), "float32"))
# The ssd_intra_chunk backward ((G, Q, N, H, P), type, variant, decay a
# step): Jamba's training shape (16 chunks of 256, bf16; its row is the
# kernel's main-path row), two chunks of 256 in both types, Q = 100 off the
# 64-row tile in both types, the smoke shape (f32), and steep decays as
# tests/test_torch_kernels_cuda.py's: at 1.0 a step the far decays fall
# below float32's normal range, at 200 nearly all underflow (every
# gradient finite).
SSD_BWD_SHAPES = (((16, 256, 128, 256, 64), "bfloat16", "", 0.2),
                  ((2, 256, 128, 20, 64), "bfloat16", "", 0.2),
                  ((2, 256, 128, 20, 64), "float32", "", 0.2),
                  ((2, 100, 128, 20, 64), "bfloat16", "Q 100", 0.2),
                  ((2, 100, 128, 20, 64), "float32", "Q 100", 0.2),
                  ((8, 8, 8, 8, 16), "float32", "", 0.2),
                  ((2, 256, 128, 20, 64), "bfloat16", "steep 1.0", 1.0),
                  ((2, 256, 128, 20, 64), "float32", "steep 200", 200.0))
LM_T, LM_DECODE_T, LM_WARMUP, LM_TIMED = 4096, 256, 3, 10
# The f32 kernels on three TF32 products (eigvec_rotate, scaled_gram), and
# f32 rbf_gram, against the f64 product of their operands: at most this
# many times the plain f32 version's largest error: the bar the CPU model
# of the arithmetic is held to (tests/test_torch_kernels_ref.py).  Three TF32
# products keep f32's accuracy only if their sums do; Hopper's tensor
# cores add with less than f32's rounding, which no CPU model shows.  With
# the tensor-core sums folded into f32 a slab at a time the rotation's
# ratio is 0.42-1.05; summed over all of k it was 4.08 (square) and 7.59
# (row block) at m = 1000 and 2.16 (square) at m = 300 (PERF.md,
# Findings PR 17).
TF32_ERR_RATIO = 2.0
# Prefill against decode (bf16): both round every product and sum they
# keep to bf16 (unit roundoff u = 2^-8), at different places (the prefill
# sums the chunk state and the attention in f32 inside the kernels; decode
# rounds the Mamba state S to bf16 at each of the prompt's steps and each
# matmul over one token, not T).  Roundings on the path from the
# embedding to the logits: ~10 per layer, 2 around the head, and the 256
# state updates: R = 10·8 + 2 + 256.  Taken as independent, each of at
# most one ulp (2u) of the hidden state, they add in quadrature:
# 2u·sqrt(R) = 0.144 of the logits' largest magnitude, for the last
# position and for the worst position alike.
LM_BAR = 2 * 2.0 ** -8 * (10 * 8 + 2 + LM_DECODE_T) ** 0.5
# DBRX cut to 4 of its 40 layers (every width as published).  Its bar is
# LM_BAR's reckoning for 4 layers: 2u·sqrt(10·4 + 2 + 256) = 0.135.  It
# holds on the positions whose routes agree in every layer: a near tie in
# the bf16-rounded router input can send one position to another expert,
# which moves its logits far past rounding; those positions are counted,
# and at least ROUTE_AGREEMENT of the (token, layer, k) choices must agree
# up to each position's first differing layer (a position routed
# elsewhere in layer l carries another hidden state into every later
# layer; the share over all choices is reported beside it).
LM_MOE_LAYERS = 4
LM_MOE_BAR = 2 * 2.0 ** -8 * (10 * LM_MOE_LAYERS + 2 + LM_DECODE_T) ** 0.5
ROUTE_AGREEMENT = 0.99
# xLSTM-125m whole.  LM_BAR's reckoning for its 12 layers (0.152) assumes
# independent roundings; the xLSTM's recurrences carry each rounding on
# through every later layer and token, in the reference as in the port, so
# the whole model's prefill-against-decode gap in bf16 is reported beside
# it, not held to it.  What is held: each block kind at full width, its
# parallel form against its recurrence over the same LM_DECODE_T inputs,
# each position's relative error within 2u·sqrt(10 + LM_DECODE_T) = 0.127
# (~10 roundings in the block and one of the state a step).  The prefill
# is 1 warm-up and 3 timed calls: its two sLSTM layers step through the
# 4096 tokens one at a time.
LM_XLSTM_BAR = 2 * 2.0 ** -8 * (10 * 12 + 2 + LM_DECODE_T) ** 0.5
LM_XLSTM_BLOCK_BAR = 2 * 2.0 ** -8 * (10 + LM_DECODE_T) ** 0.5
LM_XLSTM_CALLS = (1, 3)
# Device records of a prefill by what launched them (lower-case substrings
# of the kernel names; cuBLAS's GEMMs run as nvjet, sm90 xmma or cutlass
# kernels).
LM_GROUPS = (("flash_attention", ("flash_attention_kernel",)),
             ("ssd_intra_chunk", ("ssd_intra_chunk_kernel",)),
             ("matmul", ("gemm", "xmma", "cutlass", "gemv", "splitk",
                         "nvjet")))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseClock:
    """Each phase's wall seconds as ``main`` runs it, all of its work
    included (a phase's own ``seconds`` or ``total_s`` may cover only its
    timed part), and the seconds since the clock started."""

    def __init__(self):
        self.start = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        return out

    def emit(self) -> None:
        emit({"phase": "wall", "seconds_by_phase": self.seconds,
              "phases_s": sum(self.seconds.values()),
              "total_s": time.perf_counter() - self.start})


def emit_total(phase: str, t0: float, rows: int) -> None:
    """A phase's closing row: its row count and seconds since ``t0``."""
    emit({"phase": phase, "rows": rows,
          "total_s": time.perf_counter() - t0})


def ptxas_summary(reports: dict) -> dict:
    """Registers and spill bytes per compiled entry, from ``ptxas -v``, and
    each source's warnings (C7513 is a serialised wgmma)."""
    out = {}
    for src, text in reports.items():
        entry = None
        for line in text.splitlines():
            if "warning" in line:
                out.setdefault(src + ":warnings", []).append(line.strip())
            hit = re.search(r"Compiling entry function '(\w+)'", line)
            if hit:
                entry = hit.group(1)
            hit = re.search(r"Used (\d+) registers", line)
            if hit and entry:
                out.setdefault(src, []).append(int(hit.group(1)))
            hit = re.search(r"(\d+) bytes spill stores", line)
            if hit and entry and int(hit.group(1)):
                out.setdefault(src + ":spills", []).append(int(hit.group(1)))
    return out


def kernel_phase(torch, checks, cuda) -> dict:
    """Each kernel against its plain version, per entry within its own
    bound; returns the rows by (kernel name, dtype, m, variant).
    ``launches`` counts this phase's launches of the kernel; the service's
    counts start from zero after it."""
    t0 = time.perf_counter()
    rows = {}
    for dtype, n, m, case in all_cases(torch, checks):
        before = cuda.LAUNCHES[case.name]
        res = checks.compare(case)
        if case.exact is not None and dtype == torch.float32:
            res.update(checks.error_vs_exact(case),
                       bar_err_ratio=TF32_ERR_RATIO)
        if case.symmetric:
            K = case.kernel()[0]
            res["symmetric"] = bool(torch.equal(K, K.T))
            del K
        res["repeats_bitwise"] = checks.repeats_bitwise(case)
        row = {"phase": "kernels", "name": case.name,
               "variant": case.variant,
               "dtype": str(dtype).removeprefix("torch."), "n": n, "m": m,
               **res, "launches": cuda.LAUNCHES[case.name] - before}
        emit(row)
        if not row.get("err_ratio", 0.0) <= TF32_ERR_RATIO:
            raise AssertionError(
                f"{case.name} {case.variant} m={m}: error against f64 "
                f"{row['kernel_err_vs_f64']:.3e} is {row['err_ratio']:.2f}x "
                f"the plain f32 product's (bar {TF32_ERR_RATIO}x)")
        if not row.get("symmetric", True):
            raise AssertionError(f"{case.name} {row['dtype']} n={n} m={m}: "
                                 f"the output is not exactly symmetric")
        if not row["repeats_bitwise"]:
            raise AssertionError(f"{case.name} {case.variant} "
                                 f"{row['dtype']} m={m}: two runs differ")
        rows[case.name, row["dtype"], m, case.variant] = row
    emit_total("kernels", t0, len(rows))
    return rows


def all_cases(torch, checks):
    """(dtype, n, m, case) for every kernel at the phases' shapes: the KPCA
    kernels at bucket 1024, scaled_gram at n = 4096 (m is B's width),
    rbf_gram at ``RBF_SHAPES`` and the Fig. 2 data's full gram."""
    import dataclasses

    from repro_torch.core import kernels_fn as kf
    from repro_torch.data.uci_like import load_dataset

    for dtype in (torch.float32, torch.float64):
        for m in (MAIN_M, 300):
            for case in checks.cases(MAIN_N, m, dtype, "cuda"):
                yield dtype, MAIN_N, m, case
        for k in GRAM_K:
            for case in checks.gram_cases(GRAM_N, k, dtype, "cuda"):
                yield dtype, GRAM_N, k, case
        yield dtype, FEATURES[0], FEATURES[1], checks.features_case(
            *FEATURES, dtype, "cuda")
    for n, m, dim, dtype_name in RBF_SHAPES:
        dtype = getattr(torch, dtype_name)
        for case in checks.rbf_gram_cases(n, m, dim, dtype, "cuda"):
            yield dtype, n, m, case
    X = torch.as_tensor(load_dataset("magic", n=GRAM_N, seed=0),
                        device="cuda")
    sigma = float(kf.median_heuristic(X))
    yield torch.float64, GRAM_N, GRAM_N, checks.rbf_gram_case(X, X, sigma)
    for (B, T, H, Hkv, hd), dtype_name in FLASH_SHAPES:
        dtype = getattr(torch, dtype_name)
        yield dtype, T, H, checks.flash_attention_case(B, T, H, Hkv, hd,
                                                       dtype, "cuda")
    for B, T, H, Hkv, hd in FLASH_LSE_SHAPES:
        yield torch.bfloat16, T, H, checks.flash_attention_lse_case(
            B, T, H, Hkv, hd, "cuda")
    for (B, T, H, Hkv, hd), dtype_name in FLASH_BWD_SHAPES:
        dtype = getattr(torch, dtype_name)
        yield dtype, T, H, checks.flash_attention_bwd_case(B, T, H, Hkv, hd,
                                                           dtype, "cuda")
    for (G, Q, N, H, P), dtype_name in SSD_SHAPES:
        dtype = getattr(torch, dtype_name)
        yield dtype, G * Q, H, checks.ssd_intra_chunk_case(G, Q, N, H, P,
                                                           dtype, "cuda")
    for (G, Q, N, H, P), dtype_name, variant, decay in SSD_BWD_SHAPES:
        dtype = getattr(torch, dtype_name)
        case = checks.ssd_intra_chunk_bwd_case(G, Q, N, H, P, dtype, "cuda",
                                               decay=decay)
        yield dtype, G * Q, H, dataclasses.replace(case, variant=variant)


# The rows of the kernel phase that PERF.md's kernel table reads, and so
# the timing phase times: each kernel's main-path shape in both types,
# eigvec_rotate2's f32 row block, transform_project at C = 1 and as the
# Nyström feature head, scaled_gram at width 512, rbf_gram at 1024² and
# Fig. 2's 4096², the LM kernels at the prefills' shapes (Jamba's and
# DBRX's attention).  The kernel phase checks every row.
TIMED_VARIANTS = {"": None, "C 1": None, "C 512, features": None,
                  "rows 256:768": ("eigvec_rotate2", "float32"),
                  "lse": ("flash_attention", "bfloat16")}


# Profiled calls a timing row: 25 of a kernel (checks.device_ms's
# default), 10 of a batched launch and of its 8 singles, 5 of a plain
# version (the slowest calls, and the profiler's costliest events).
BATCHED_REPS, PLAIN_REPS = 10, 5


def timed_row(name: str, variant: str, n: int, m: int, dtype) -> bool:
    if variant not in TIMED_VARIANTS:
        return False
    only = TIMED_VARIANTS[variant]
    dtype_name = str(dtype).removeprefix("torch.")
    if only is not None and only != (name, dtype_name):
        return False
    if name in ("eigvec_rotate", "eigvec_rotate2", "eigvec_project",
                "krow_project", "transform_project"):
        return n != MAIN_N or m == MAIN_M
    if name == "scaled_gram":
        return m == GRAM_K[0]
    if name == "rbf_gram":
        return (n, m) in ((1024, 1024), (GRAM_N, GRAM_N))
    if name == "flash_attention" and variant == "lse":
        return (n, m) == FLASH_LSE_SHAPES[0][1:3]
    if name == "flash_attention":
        return (m, dtype_name) in ((shape[2], dt) for shape, dt
                                   in FLASH_SHAPES[:3])
    if name == "flash_attention_bwd":
        return (m, dtype_name) in ((shape[2], dt) for shape, dt
                                   in FLASH_BWD_SHAPES[:2])
    if name == "ssd_intra_chunk_bwd":
        return (m, dtype_name) == (SSD_BWD_SHAPES[0][0][3],
                                   SSD_BWD_SHAPES[0][1])
    return (m, dtype_name) == (SSD_SHAPES[0][0][3], SSD_SHAPES[0][1])


def timing_phase(torch, checks) -> dict:
    """Each kernel's time beside its plain version's, one library call's
    and its bound, at the kernel phase's shapes that the kernel table
    reads (``timed_row``).  Runs after the
    service, so the profiler (CUPTI) is never attached while the main path
    is timed.  ``ms`` and ``plain_ms`` are device time per call (the
    profiler's CUDA activity records, or ``checks.queued_ms`` where the
    profiler records nothing: ``timed_by`` says which).  ``library_ms`` is
    ``checks.queued_ms``'s: the script does not know how many kernels a
    library call launches, so a profile that lost every record of one of
    them passes ``device_ms``'s check (the f64 two-product call once read
    half its queued time, one launch a call).  The ``*call_ms`` twins time
    whole calls between CUDA events, the wrapper's host work included."""
    t_phase = time.perf_counter()
    rows = {}
    for dtype, n, m, case in all_cases(torch, checks):
        if not timed_row(case.name, case.variant, n, m, dtype):
            continue
        t0 = time.perf_counter()
        ms, per_call = checks.device_ms(case.kernel)
        plain_ms, plain_per_call = checks.device_ms(case.plain,
                                                    reps=PLAIN_REPS)
        bound_ms, bound_by = case.bound(dtype)
        row = {"phase": "timing", "name": case.name,
               "variant": case.variant,
               "dtype": str(dtype).removeprefix("torch."), "n": n, "m": m,
               "ms": ms, "timed_by": ("profiler" if per_call is not None
                                      else "queued events"),
               "device_launches_per_call": per_call,
               "call_ms": checks.call_ms(case.kernel),
               "plain_ms": plain_ms,
               "plain_device_launches_per_call": plain_per_call,
               "plain_call_ms": checks.call_ms(case.plain),
               "library_ms": (checks.queued_ms(case.library)
                              if case.library else None),
               "library_call_ms": (checks.call_ms(case.library)
                                   if case.library else None),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "seconds": time.perf_counter() - t0}
        emit(row)
        rows[case.name, row["dtype"], m, case.variant] = row
    emit_total("timing", t_phase, len(rows))
    return rows


def oracle_check(torch, state, spec, adjusted: bool,
                 dtype_name: str) -> dict:
    """Top-8 eigenpairs of a streamed state against eigh of the batch gram
    of its active points (centered where the stream is ``adjusted``)."""
    from repro_torch.core import batch, engine as eng, kernels_fn as kf

    top = 8
    m = int(state.m)
    X = state.X[:m].double()
    K = kf.gram_block(X, X, spec=spec)
    lam_ref, vec_ref = batch.batch_kpca(K, adjusted=adjusted)
    lam_ref, vec_ref = lam_ref.flip(0)[:top], vec_ref.flip(1)[:, :top]
    lam, vec = eng.eigpairs(state)
    lam, vec = lam[:top].double(), vec[:m, :top].double()
    rel = float(((lam - lam_ref).abs() / lam_ref.abs()).max())
    cos = float(torch.linalg.svdvals(vec_ref.T @ vec).min())
    bar_rel, bar_cos = BARS[dtype_name]
    if not (rel <= bar_rel and cos >= bar_cos):
        raise AssertionError(f"{dtype_name} final state off the eigh oracle: "
                             f"eigenvalue rel err {rel:.3e} (bar {bar_rel}), "
                             f"subspace min cos {cos:.9f} (bar {bar_cos})")
    return {"top8_eig_rel_err": rel, "top8_subspace_min_cos": cos,
            "bar_rel_err": bar_rel, "bar_min_cos": bar_cos}


def service_phase(torch, cuda, serve, capacity: int, points: int,
                  dtype_name: str, matmul: str) -> dict:
    """The KPCA service through its entry point, with the launch counts
    read around it and checked against the reckoning."""
    args = serve.parse_args([
        "--mode", "kpca", "--device", "cuda", "--dtype", dtype_name,
        "--capacity", str(capacity), "--points", str(points),
        "--dim", "16", "--batch", "64", "--transform-every", "16",
        "--matmul", matmul])
    cuda.reset_launches()
    result, stream = serve.kpca_service(args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    expect = {"eigvec_rotate": 4 * points, "eigvec_rotate2": 0,
              "krow_project": points, "eigvec_project": points,
              "transform_project": points // args.transform_every,
              "scaled_gram": 0, "rbf_gram": 0, "flash_attention": 0,
              "flash_attention_bwd": 0,
              "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    if matmul == "pallas2":
        expect.update(pair_reckoning(launches, 2 * points))
    if launches != expect:
        raise AssertionError(f"{matmul} launch counts {launches} != {expect}")
    if not (result["finite"] and torch.isfinite(stream.state.U).all()):
        raise AssertionError("non-finite state")
    if result["m_final"] != 4 + points:
        raise AssertionError(f"m_final {result['m_final']} != {4 + points}")
    keep = ("m_final", "finite", "update_ms_p50", "update_ms_p90",
            "update_ms_p99", "update_ms_max", "update_ms_compile_ms",
            "query_ms_p50", "query_ms_p90", "query_ms_p99", "query_ms_max",
            "transforms_served", "total_s")
    row = {"phase": "service", "matmul": matmul, "dtype": dtype_name,
           "capacity": capacity, "points": points,
           **{k: result[k] for k in keep}, "launches": launches,
           "merge_fallback_pairs": launches["eigvec_rotate"] // 2
           if matmul == "pallas2" else None,
           **oracle_check(torch, stream.state, stream.spec, True,
                          dtype_name)}
    emit(row)
    return row


def pair_reckoning(launches: dict, pairs: int) -> dict:
    """The rotation counts of ``pairs`` fused pairs, given how many single
    rotations ran: each pair is one ``eigvec_rotate2`` launch, or two
    ``eigvec_rotate`` launches where its cluster merge fired."""
    rot = launches["eigvec_rotate"]
    return {"eigvec_rotate": rot, "eigvec_rotate2": pairs - rot / 2}


def exact_trace_error(torch, rows, landmarks, spec, capacity: int,
                      dtype) -> dict:
    """Σ_i k(x_i, x_i) - K̃_ii of the exact Nyström approximation from the
    dense grams, its pseudo-inverse cut where ``nystrom._pinv_lam`` cuts
    the run's: eigenvalues at most capacity·eps(dtype)·λmax are dropped.
    ``f64`` takes eigh of the f64 gram; ``eigh`` the same sum with every
    step in the run's type, the one-shot floor of that type; ``kept`` the
    eigenvalues past the cut; ``min_eig`` the smallest of them (f64)."""
    from repro_torch.core import kernels_fn as kf

    out = {}
    for key, dt in (("f64", torch.float64), ("eigh", dtype)):
        R, X = rows.to(dt), landmarks.to(dt)
        lam, V = torch.linalg.eigh(kf.gram_block(X, X, spec=spec))
        ok = lam > capacity * torch.finfo(dtype).eps * lam.max()
        B = kf.gram_block(R, X, spec=spec) @ V[:, ok]
        diag = kf.kernel_diag(R, spec=spec)
        out[key] = float((diag - (B ** 2 / lam[ok]).sum(1)).sum())
        if key == "f64":
            out["kept"], out["min_eig"] = int(ok.sum()), float(lam[ok].min())
    return out


def nystrom_phase(torch, cuda, serve, dtype_name: str) -> dict:
    """The landmark service through its entry point: launches against the
    reckoning, final trace error against the f64 recomputation, final
    eigensystem against eigh of the landmarks' gram."""
    from repro_torch.core import kernels_fn as kf, nystrom, rankone

    capacity, points = 512, 1000
    args = serve.parse_args([
        "--mode", "nystrom", "--device", "cuda", "--dtype", dtype_name,
        "--capacity", str(capacity), "--points", str(points), "--dim", "16",
        "--matmul", "pallas2"])
    cuda.reset_launches()
    result, state = serve.nystrom_service(args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    adm = capacity - 1 - 4
    expect = {"eigvec_project": 0, "krow_project": adm,
              "transform_project": 0, "scaled_gram": 0, "rbf_gram": 0,
              "flash_attention": 0,
              "flash_attention_bwd": 0, "ssd_intra_chunk": 0,
              "ssd_intra_chunk_bwd": 0,
              **pair_reckoning(launches, adm)}
    if result["admitted"] != adm or launches != expect:
        raise AssertionError(f"nystrom: {result['admitted']} admissions, "
                             f"launches {launches} != {expect}")
    m = result["m_final"]
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    st = state.kpca
    ref = exact_trace_error(torch, state.Xrows, st.X[:m], spec, capacity,
                            st.L.dtype)
    exact = ref["f64"]
    rel = abs(result["trace_error"] - exact) / abs(exact)
    mask = rankone.active_mask(capacity, st.m)
    pinv = nystrom._pinv_lam(st.L, mask) != 0
    kept = int(pinv.sum())
    bar = NYSTROM_BARS[dtype_name]
    if not (result["finite"] and rel <= bar and kept == ref["kept"]):
        raise AssertionError(f"nystrom {dtype_name}: trace_error "
                             f"{result['trace_error']!r} vs f64 {exact!r}: "
                             f"relative {rel:.3e} (bar {bar}); pseudo-"
                             f"inverse keeps {kept} vs {ref['kept']}")
    lam_min = float(st.L[pinv].min())
    # The run's own eigensystem and rows, summed in f64: what is left of
    # the gap is the eigensystem's, not the final evaluation's.
    up = {k: v.double() for k, v in st._asdict().items()
          if torch.is_tensor(v) and v.is_floating_point()}
    own64 = float(nystrom.trace_error(state._replace(
        kpca=st._replace(**up), Knm=state.Knm.double(),
        Xrows=state.Xrows.double()), spec))
    keep = ("m_final", "rows", "admitted", "rejected", "trace_error",
            "step_ms_p50", "step_ms_p90", "step_ms_p99", "step_ms_max",
            "total_s")
    row = {"phase": "nystrom", "dtype": dtype_name, "capacity": capacity,
           "points": points, **{k: result[k] for k in keep},
           "trace_error_f64": exact, "trace_error_rel_err": rel,
           "bar_trace_rel_err": bar, "pinv_kept": kept,
           "trace_error_own_f64": own64,
           "trace_error_own_f64_rel_err": abs(own64 - exact) / abs(exact),
           "trace_error_eigh": ref["eigh"],
           "trace_error_eigh_rel_err": abs(ref["eigh"] - exact) / abs(exact),
           "min_eig": lam_min, "min_eig_f64": ref["min_eig"],
           "min_eig_rel_err": abs(lam_min - ref["min_eig"]) / ref["min_eig"],
           **oracle_check(torch, st, spec, False, dtype_name),
           "launches": launches,
           "merge_fallback_pairs": launches["eigvec_rotate"] // 2}
    emit(row)
    return row, state


def fig2_phase(torch, cuda, checks) -> dict:
    """The Fig. 2 loop on ``magic_like`` (f64, fixed rows), landmarks grown
    by ``Engine.add_landmark`` on the main path's plan; at each checkpoint
    K̃ from the kernel against the plain version entry by entry, the
    trace identity, and a non-increasing trace error."""
    import numpy as np

    from repro_torch.core import engine as eng, kernels_fn as kf, nystrom
    from repro_torch.data.uci_like import load_dataset

    n, m0, checkpoints = GRAM_N, 16, (64, 128, 256, 512)
    X = torch.as_tensor(load_dataset("magic", n=n, seed=0), device="cuda")
    spec = kf.KernelSpec(name="rbf", sigma=float(kf.median_heuristic(X)))
    K = kf.gram_block(X, X, spec=spec)
    order = np.random.default_rng(0).permutation(n)
    capacity = max(checkpoints)
    engine = eng.Engine(spec, eng.UpdatePlan(matmul="pallas2",
                                             fuse_krow=True,
                                             dispatch="bucketed"),
                        adjusted=False)
    state = nystrom.init_nystrom(X, X[order[:m0]], capacity, spec,
                                 dtype=torch.float64)
    cuda.reset_launches()
    rows, prev = [], None
    t0 = time.perf_counter()
    m = m0
    for ck in checkpoints:
        while m < ck:
            state = engine.add_landmark(state, X, X[order[m]])
            m += 1
        Kt = nystrom.reconstruct_tilde(state, use_pallas=True)
        B, s = nystrom.recon_factors(state)
        err = (Kt - nystrom.reconstruct_tilde(state)).abs()
        tol = checks.scaled_gram_tol(B, s, torch.float64)
        if not bool((err <= tol).all()):
            raise AssertionError(f"fig2 m={ck}: K̃ from scaled_gram off its "
                                 f"plain version beyond the bound "
                                 f"({float((err / tol).max()):.3e} x)")
        norms = nystrom.approximation_error(K, Kt)
        tr = float(nystrom.trace_error(state, spec, X))
        rel = abs(norms.trace - tr) / abs(tr)
        if rel > FIG2_REL or (prev is not None and tr > prev):
            raise AssertionError(f"fig2 m={ck}: trace norm {norms.trace!r} "
                                 f"vs trace_error {tr!r} (rel {rel:.3e}, "
                                 f"bar {FIG2_REL}), previous {prev!r}")
        prev = tr
        rows.append({"m": ck, "fro": norms.fro, "spectral": norms.spectral,
                     "trace": norms.trace, "trace_error": tr,
                     "trace_rel_diff": rel,
                     "recon_err_over_tol": float((err / tol).max())})
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    grown = max(checkpoints) - m0
    expect = {"eigvec_project": 0, "krow_project": grown,
              "transform_project": 0, "scaled_gram": len(checkpoints),
              "rbf_gram": 0, "flash_attention": 0,
              "flash_attention_bwd": 0, "ssd_intra_chunk": 0,
              "ssd_intra_chunk_bwd": 0,
              **pair_reckoning(launches, grown)}
    if launches != expect:
        raise AssertionError(f"fig2 launch counts {launches} != {expect}")
    row = {"phase": "fig2", "n": n, "sigma": spec.sigma,
           "checkpoints": rows, "launches": launches,
           "total_s": time.perf_counter() - t0}
    emit(row)
    return row


def window_phase(torch, cuda, serve, capacity: int, window: int,
                 points: int, dtype_name: str, matmul: str) -> dict:
    """The sliding-window service through its entry point: launches
    against the reckoning, the window's rows and ages exactly, the final
    eigensystem against eigh of the window's points, and the latency of
    growth and steady-state points apart."""
    import numpy as np

    args = serve.parse_args([
        "--mode", "kpca", "--device", "cuda", "--dtype", dtype_name,
        "--capacity", str(capacity), "--window", str(window),
        "--points", str(points), "--dim", "16", "--batch", "64",
        "--transform-every", "16", "--matmul", matmul])
    cuda.reset_launches()
    result, stream = serve.kpca_service(args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    growth, steady = window - 4, points - (window - 4)
    # A growth point is the service's (2 pairs); a steady-state point adds
    # the downdate's two inverse pairs.  Each point: 1 k-row pass and 1
    # projection; 1 transform per query batch.
    expect = {"eigvec_rotate": 4 * growth + 8 * steady, "eigvec_rotate2": 0,
              "krow_project": points, "eigvec_project": points,
              "transform_project": points // args.transform_every,
              "scaled_gram": 0, "rbf_gram": 0, "flash_attention": 0,
              "flash_attention_bwd": 0,
              "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    if matmul == "pallas2":
        expect.update(pair_reckoning(launches, 2 * growth + 4 * steady))
    if launches != expect:
        raise AssertionError(f"window {matmul} launch counts {launches} != "
                             f"{expect}")
    if (result["growth_points"], result["steady_points"]) != (growth,
                                                              steady):
        raise AssertionError(f"window phases {result['growth_points']} / "
                             f"{result['steady_points']} != {growth} / "
                             f"{steady}")
    st = stream.kpca_state
    x0, draws = serve.kpca_draws(args)
    last = np.concatenate([x0, [x for x, _ in draws]])[-window:]
    want = torch.as_tensor(last, dtype=st.X.dtype, device=st.X.device)
    ages = stream.state.ages[:window].tolist()
    if not (result["finite"] and result["m_final"] == window
            and torch.equal(st.X[:window], want)
            and ages == list(range(4 + points - window, 4 + points))):
        raise AssertionError(f"window {matmul}: m {result['m_final']}, the "
                             f"rows are not the last {window} points in "
                             f"arrival order, or the ages are not "
                             f"consecutive ({ages[:3]}...{ages[-3:]})")
    keep = [f"{p}_update_ms_{q}" for p in ("growth", "steady")
            for q in ("p50", "p90", "p99", "max")]
    keep += ["m_final", "update_ms_p50", "query_ms_p50", "query_ms_p99",
             "transforms_served", "total_s"]
    row = {"phase": "window", "matmul": matmul, "dtype": dtype_name,
           "capacity": capacity, "window": window, "points": points,
           "growth_points": growth, "steady_points": steady,
           **{k: result[k] for k in keep}, "launches": launches,
           "merge_fallback_pairs": launches["eigvec_rotate"] // 2
           if matmul == "pallas2" else None,
           **oracle_check(torch, st, stream.spec, True, dtype_name)}
    emit(row)
    return row


def _count_syncs(torch, fn, out: list):
    """``fn`` wrapped so that each call's synchronizing CUDA operations
    (torch's sync debug mode) are appended to ``out``."""
    import warnings

    def counted(*args, **kw):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        out.append(sum("synchroniz" in str(w.message) for w in seen))
        return res

    return counted


def _offer_syncs(torch, engine_cls, log: dict):
    """Wrap ``engine_cls.offer_landmark`` so that each call's synchronizing
    CUDA operations (reads to the host, blocking copies) are counted under
    its action, by torch's sync debug mode; returns the undo."""
    orig = engine_cls.offer_landmark
    counts: list = []

    def offer(self, *args, **kw):
        state, action = _count_syncs(torch, orig, counts)(self, *args, **kw)
        log.setdefault(action, []).append(counts.pop())
        return state, action

    engine_cls.offer_landmark = offer
    return lambda: setattr(engine_cls, "offer_landmark", orig)


def lifecycle_phase(torch, cuda, serve, dtype_name: str, capacity: int,
                    budget: int, points: int, extra=()) -> dict:
    """The leverage landmark service through its entry point: every offer
    accounted for, the final trace error against the f64 recomputation,
    the eigensystem against eigh of the landmarks' gram, and the
    synchronizing operations inside each offer by its action."""
    from repro_torch.core import engine as eng, kernels_fn as kf

    args = serve.parse_args([
        "--mode", "nystrom", "--device", "cuda", "--dtype", dtype_name,
        "--capacity", str(capacity), "--landmark-budget", str(budget),
        "--points", str(points), "--dim", "16", "--landmark-policy",
        "leverage", *extra])
    syncs: dict = {}
    undo = _offer_syncs(torch, eng.Engine, syncs)
    cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        result, state = serve.nystrom_service(args)
    finally:
        undo()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    counts = {k: result[k] for k in ("admitted", "replaced", "rejected")}
    offers = sum(len(v) for v in syncs.values())
    m = result["m_final"]
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    st = state.kpca
    exact = exact_trace_error(torch, state.Xrows, st.X[:m], spec, capacity,
                              st.L.dtype)["f64"]
    rel = abs(result["trace_error"] - exact) / abs(exact)
    bar = NYSTROM_BARS[dtype_name]
    # An admission is one k-row pass and one pair (2 rotations); a swap
    # adds the removal's inverse pair.
    adm, rep = counts["admitted"], counts["replaced"]
    expect = {name: 0 for name in launches}
    expect.update(eigvec_rotate=2 * adm + 4 * rep, krow_project=adm + rep)
    if not (sum(counts.values()) == points and result["finite"]
            and m == 4 + adm and rel <= bar and launches == expect):
        raise AssertionError(f"lifecycle {dtype_name}: counts {counts} of "
                             f"{points} offers, m {m}, trace_error "
                             f"{result['trace_error']!r} vs f64 {exact!r} "
                             f"(relative {rel:.3e}, bar {bar}), launches "
                             f"{launches} != {expect}")
    row = {"phase": "lifecycle", "dtype": dtype_name, "capacity": capacity,
           "budget": budget, "points": points, "args": list(extra),
           **counts, "offers_made": offers,
           **{k: result[k] for k in ("m_final", "rows", "trace_error",
                                     "stopped_at", "tracker_drift",
                                     "tracker_resyncs", "step_ms_p50",
                                     "step_ms_p99")},
           "trace_error_f64": exact, "trace_error_rel_err": rel,
           "bar_trace_rel_err": bar,
           "syncs_per_offer": {k: sum(v) / len(v) for k, v in syncs.items()},
           **oracle_check(torch, st, spec, False, dtype_name),
           "seconds": seconds, "launches": launches}
    emit(row)
    return row


def swap_phase(torch, cuda, capacity: int = 256, budget: int = 128,
               swaps: int = 200) -> dict:
    """The replacement path at the lifecycle's f64 shape: the leverage
    arm does not fire on an i.i.d. stream (ridge leverage saturates near 1
    above a normalised residual below 1), so landmarks are admitted to the
    budget and then every new point replaces the lowest-leverage landmark
    through ``Engine.replace_landmark``, the tracker fed the swap delta
    with the victim passed through.  The tracked and final trace errors
    against the f64 recomputation, the eigensystem against eigh, and one
    donating swap against the copying one bit for bit, on its own storage."""
    import numpy as np

    from repro_torch.core import engine as eng, kernels_fn as kf, nystrom

    dt = torch.float64
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    engine = eng.Engine(spec, eng.UpdatePlan(
        matmul="pallas", dispatch="bucketed", fuse_krow=True,
        landmark_policy="leverage"), adjusted=False)
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.normal(size=(budget + swaps + 1, 16)),
                         dtype=dt, device="cuda")
    state = nystrom.init_nystrom(None, xs[:4], capacity, spec, dtype=dt,
                                 grow_rows=True)
    tracker = nystrom.TraceErrorTracker(state, spec, resync_every=10_000)
    cuda.reset_launches()
    t0 = time.perf_counter()
    m = 4
    for x in xs[4:budget]:
        tracker.observe(state, x)
        state = nystrom.observe_rows(state, x, spec, plan=engine.plan, m=m)
        prev = state
        state = engine.add_landmark(state, None, x, m=m)
        tracker.admitted(prev, x)
        m += 1
    victims = []
    for x in xs[budget:budget + swaps]:
        tracker.observe(state, x)
        state = nystrom.observe_rows(state, x, spec, plan=engine.plan, m=m)
        j = int(np.argmin(nystrom.leverage_scores(state)[:m].cpu().numpy()))
        prev = state
        state = engine.replace_landmark(state, None, j, x, m=m)
        tracker.replaced(state, state_before=prev, x=x, j=j)
        victims.append(j)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = float(nystrom.trace_error(state, spec))
    exact = exact_trace_error(torch, state.Xrows, state.kpca.X[:m], spec,
                              capacity, dt)["f64"]
    rel, drift = abs(err - exact) / exact, abs(tracker.value - exact) / exact
    # One more swap, copying and donating, from the same state.
    x = xs[-1]
    j = int(np.argmin(nystrom.leverage_scores(state)[:m].cpu().numpy()))
    ref = engine.replace_landmark(state, None, j, x, m=m)
    spare = state._replace(kpca=state.kpca._replace(**{
        k: v.clone() for k, v in state.kpca._asdict().items()}),
        Knm=state.Knm.clone())
    ptrs = (spare.Knm.data_ptr(), spare.kpca.U.data_ptr())
    out = engine.replace_landmark(spare, None, j, x, m=m, donate=True)
    donated = ((out.Knm.data_ptr(), out.kpca.U.data_ptr()) == ptrs
               and torch.equal(out.Knm, ref.Knm)
               and all(torch.equal(getattr(out.kpca, f), getattr(ref.kpca, f))
                       for f in ref.kpca._fields))
    bar = NYSTROM_BARS["float64"]
    adm, rep = budget - 4, swaps + 2
    launches = dict(cuda.LAUNCHES)
    expect = {name: 0 for name in launches}
    expect.update(eigvec_rotate=2 * adm + 4 * rep, krow_project=adm + rep)
    if not (rel <= bar and drift <= bar and donated and launches == expect
            and tracker.resyncs == 0 and int(state.kpca.m) == budget):
        raise AssertionError(f"swaps: trace_error {err!r}, tracked "
                             f"{tracker.value!r}, f64 {exact!r} (bar {bar}); "
                             f"donated swap equal on its storage {donated}; "
                             f"resyncs {tracker.resyncs}; launches "
                             f"{launches} != {expect}")
    row = {"phase": "lifecycle_swaps", "dtype": "float64",
           "capacity": capacity, "budget": budget, "swaps": swaps,
           "distinct_victims": len(set(victims)), "trace_error": err,
           "tracked": tracker.value, "trace_error_f64": exact,
           "trace_error_rel_err": rel, "tracker_rel_err": drift,
           "bar_rel_err": bar, "tracker_resyncs": tracker.resyncs,
           "donate_equals_copy_in_place": donated,
           **oracle_check(torch, state.kpca, spec, False, "float64"),
           "seconds": seconds, "launches": launches}
    emit(row)
    return row


def truncate_phase(torch, cuda, serve, points: int = 600, more: int = 150,
                   k: int = 64, capacity: int = 1024) -> dict:
    """``KPCAStream.truncate`` on the f32 ``pallas`` Algorithm-2 service:
    ``points`` points, then ``truncate(k)`` compacted (at unchanged
    capacity) and uncompacted (the row-support floor carried), then
    ``more`` points each.  Held: exactly k active, the kept columns
    orthonormal, both branches finite; uncompacted, the kept eigenvalues
    the k largest before bit for bit, and the branch 100 points on equal
    to the same stream under fixed dispatch within the f32 eigenvalue bar
    (the floor keeps the bucket at the capacity, where it would slice at
    128).  Reported, not held: the top-3 eigenvalues
    against eigh of every point (the reference's subset-tracking bars,
    25 % and 0.95), which the reference's own truncation misses under
    Algorithm 2 (ROADMAP.md §3)."""
    import copy

    import numpy as np

    from repro_torch.core import batch, engine as eng, inkpca
    from repro_torch.core import kernels_fn as kf

    args = serve.parse_args(["--mode", "kpca", "--device", "cuda",
                             "--capacity", str(capacity), "--dim", "16"])
    plan = serve.make_plan(args)
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.normal(size=(4 + points + more, 16)),
                        dtype=torch.float32, device="cuda")
    cuda.reset_launches()
    t0 = time.perf_counter()
    stream = inkpca.KPCAStream(X[:4], capacity, spec, plan=plan,
                               dtype=torch.float32, device="cuda")
    stream.update_block(X[4:4 + points])
    lam_before = eng.eigpairs(stream.kpca_state)[0][:k]
    K = kf.gram_block(X.double(), X.double(), spec=spec)
    lam_ref = batch.batch_kpca(K, adjusted=True)[0].flip(0)[:3]
    out, ends, cut = {}, {}, 100
    for name in ("compact", "floor", "fixed"):
        s = copy.deepcopy(stream)
        if name == "fixed":
            s.engine = eng.Engine(spec, plan._replace(dispatch="fixed"))
        s.truncate(k, compact=name == "compact",
                   capacity=capacity if name == "compact" else None)
        st = s.kpca_state
        lam, vec = eng.eigpairs(st)
        gram = vec[:, :k].double().T @ vec[:, :k].double()
        orth = float((gram - torch.eye(k, dtype=torch.float64,
                                       device="cuda")).abs().max())
        kept_equal = bool(torch.equal(lam[:k], lam_before))
        m_after, floor = int(st.m), s._min_rows
        if not (m_after == k and orth <= 1e-3
                and (name == "compact" or kept_equal)):
            raise AssertionError(f"truncate {name}: {m_after} active, "
                                 f"kept columns {orth:.3e} off "
                                 f"orthonormal, kept eigenvalues equal "
                                 f"{kept_equal}")
        s.update_block(X[4 + points:4 + points + cut])
        ends[name] = s.kpca_state
        if name == "fixed":
            continue
        s.update_block(X[4 + points + cut:])
        st = s.kpca_state
        top = eng.eigpairs(st)[0][:3].double()
        finite = bool(torch.isfinite(st.L).all()
                      and torch.isfinite(st.U).all())
        out[name] = {
            "m_after_truncate": m_after, "min_rows": floor,
            "kept_eig_bitwise": kept_equal, "kept_orth_err": orth,
            "finite": finite, "m_final": int(st.m), "top3": top.tolist(),
            "top3_rel_err": ((top - lam_ref).abs() / lam_ref).tolist(),
            "top1_ratio": float(top[0] / lam_ref[0])}
        if not finite:
            raise AssertionError(f"truncate {name}: {out[name]}")
    # Two runs of one f32 stream on the card differ at rounding level (a
    # run is not bit-reproducible: ROADMAP.md §3), so the floor branch is
    # held to fixed dispatch at the f32 eigenvalue bar, ``cut`` points on.
    fl, fx = ends["floor"], ends["fixed"]
    floor_vs_fixed = float((fl.L - fx.L).abs().max()
                           / fx.L[:int(fx.m)].abs().max())
    same = (floor_vs_fixed <= BARS["float32"][0]
            and torch.equal(fl.X, fx.X) and int(fl.m) == int(fx.m))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    n_upd = points + 2 * more + cut
    expect = {name: 0 for name in launches}
    expect.update(eigvec_rotate=4 * n_upd, krow_project=n_upd,
                  eigvec_project=n_upd)
    if not same or launches != expect:
        raise AssertionError(f"truncate: floor branch against fixed "
                             f"dispatch {floor_vs_fixed:.3e} of λmax (bar "
                             f"{BARS['float32'][0]}); launches {launches} "
                             f"!= {expect}")
    row = {"phase": "truncate", "dtype": "float32", "capacity": capacity,
           "points": points, "k": k, "more": more,
           "eigh_top3": lam_ref.tolist(), **out,
           "floor_vs_fixed_eig_rel": floor_vs_fixed,
           "bars": {"kept_orth": 1e-3, "kept_eig": "bitwise (floor)",
                    "floor_vs_fixed_eig_rel": BARS["float32"][0],
                    "not_held": "top3 within 0.25, top1 >= 0.95 of eigh"},
           "seconds": time.perf_counter() - t0, "launches": launches}
    emit(row)
    return row


def krr_phase(torch, cuda, capacity: int = 1024, points: int = 700,
              lam: float = 0.1, held_out: int = 256, loo: int = 128) -> dict:
    """``core/krr.py`` in f64 on the card (its rotations on the f64
    ``eigvec_rotate``): α against a dense solve of (K + λI)α = y, the
    published predict head (``transform_project`` at C = 1) against
    ``predict`` per entry within the kernel's bound, and the closed-form
    LOOCV residuals against refits without each of the first ``loo``
    points."""
    import numpy as np

    from repro_torch.core import engine as eng, kernels_fn as kf, krr
    from repro_torch.kernels import checks

    dt = torch.float64
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    plan = eng.UpdatePlan(matmul="pallas", fuse_krow=True)
    rng = np.random.default_rng(3)
    Xn = rng.normal(size=(4 + points + held_out, 16))
    yn = (np.sin(Xn[:, 0]) + 0.5 * np.cos(2 * Xn[:, 1])
          + 0.05 * rng.normal(size=len(Xn)))
    X = torch.as_tensor(Xn, dtype=dt, device="cuda")
    y = torch.as_tensor(yn, dtype=dt, device="cuda")
    n = 4 + points
    cuda.reset_launches()
    t0 = time.perf_counter()
    state = krr.init_krr(X[:4], y[:4], capacity, spec)
    for i in range(4, n):
        state = krr.add_point(state, X[i], y[i], spec, plan=plan)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    K = kf.gram_block(X[:n], X[:n], spec=spec)
    eye = torch.eye(n, dtype=dt, device="cuda")
    alpha_ref = torch.linalg.solve(K + lam * eye, y[:n])
    alpha = krr.coefficients(state, lam)[:n]
    alpha_err = float((alpha - alpha_ref).abs().max()
                      / alpha_ref.abs().max())
    snap = krr.publish_predict(state, lam)
    xq = X[n:]
    pred = krr.snapshot_predict(snap, xq, spec, plan=plan)
    direct = krr.predict(state, xq, lam, spec)
    tol = 2 * checks.transform_tol(xq, snap.X, snap.S, n, spec,
                                   dt)[0][:, 0]
    pred_ratio = float(((pred - direct).abs() / tol).max())
    e = krr.loocv_residuals(state, lam)[:loo]
    brute = []
    for i in range(loo):
        keep = torch.arange(n, device="cuda") != i
        a = torch.linalg.solve(K[keep][:, keep] + lam * eye[:n - 1, :n - 1],
                               y[:n][keep])
        brute.append(y[i] - K[i, keep] @ a)
    loo_err = float((e - torch.stack(brute)).abs().max())
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    bars = {"alpha_rel": 1e-8, "pred_over_bound": 1.0, "loocv_abs": 1e-6}
    expect_rot = 2 * points
    if not (alpha_err <= bars["alpha_rel"] and pred_ratio <= 1.0
            and loo_err <= bars["loocv_abs"]
            and launches["eigvec_rotate"] == expect_rot
            and launches["transform_project"] == 1):
        raise AssertionError(f"krr: alpha rel err {alpha_err:.3e}, "
                             f"predictions {pred_ratio:.3f}x their bound, "
                             f"LOOCV {loo_err:.3e}, launches {launches} "
                             f"(bars {bars}; {expect_rot} rotations)")
    row = {"phase": "krr", "dtype": "float64", "capacity": capacity,
           "points": points, "lam": lam, "alpha_rel_err": alpha_err,
           "held_out": held_out, "pred_err_over_bound": pred_ratio,
           "loocv_points": loo, "loocv_max_abs_err": loo_err, "bars": bars,
           "bound": "2x transform bound: 2(m+2)eps(|Kq||alpha|) + "
                    "epilogue, per prediction",
           "fit_s": t_fit, "seconds": time.perf_counter() - t0,
           "launches": launches}
    emit(row)
    return row


def snapshots_phase(torch, cuda, nystrom_state, capacity: int = 1024,
                    C: int = 8) -> dict:
    """``DoubleBuffer`` over the f32 service at capacity 1024, C = 8: the
    front reads bit for bit the same through 64 ingested points,
    generations 0..3, the third publish in the first's storage while the
    snapshot each publish retires stays untouched; ``query_batch`` over 4
    stacked snapshots against 4 queries bit for bit; and the Nyström
    feature head (``transform_project`` at C = M = 512) against
    ``query_features`` on the masked gram, per entry within twice the
    kernel's bound."""
    import numpy as np

    from repro_torch.core import engine as eng, inkpca
    from repro_torch.core import kernels_fn as kf, nystrom, serving
    from repro_torch.kernels import checks

    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    plan = eng.UpdatePlan(matmul="pallas", fuse_krow=True,
                          dispatch="bucketed")
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(4 + 60 + 64 + 3, 16)),
                        dtype=torch.float32, device="cuda")
    q = torch.as_tensor(rng.normal(size=(4, 64, 16)), dtype=torch.float32,
                        device="cuda")
    cuda.reset_launches()
    t0 = time.perf_counter()
    stream = inkpca.KPCAStream(X[:4], capacity, spec, plan=plan,
                               device="cuda")
    stream.update_block(X[4:64])
    buf = serving.DoubleBuffer(stream.kpca_state, n_components=C)
    y0 = buf.query(q[0], spec=spec, plan=plan)
    stable = True
    for x in X[64:128]:
        stream.update(x)
        stable &= torch.equal(buf.query(q[0], spec=spec, plan=plan), y0)
    snaps, gens, reuse, untouched = [buf.front], [0], [], []
    fresh = [serving.publish_transform(stream.kpca_state, n_components=C,
                                       adjusted=True)]
    for x in X[128:]:
        front = buf.front
        y_front = serving.query(front, q[1], spec=spec, plan=plan)
        stream.update(x)
        snaps.append(buf.publish(stream.kpca_state))
        fresh.append(serving.publish_transform(
            stream.kpca_state, n_components=C, adjusted=True))
        gens.append(int(snaps[-1].generation))
        untouched.append(torch.equal(
            serving.query(front, q[1], spec=spec, plan=plan), y_front))
        if len(snaps) > 2:
            reuse.append(snaps[-1].S.data_ptr() == snaps[-3].S.data_ptr()
                         and snaps[-1].X.data_ptr() == snaps[-3].X.data_ptr())
    yb = serving.query_batch(serving.stack_snapshots(fresh), q, spec=spec,
                             plan=plan)
    batch_equal = all(torch.equal(yb[b], serving.query(
        fresh[b], q[b], spec=spec, plan=plan)) for b in range(4))
    n = nystrom_state.Knm.shape[0]
    fsnap = nystrom.publish_features(nystrom_state, n)
    feats = nystrom.snapshot_features(fsnap, q[0], spec, plan=plan)
    plain = nystrom.query_features(nystrom_state, q[0], n, spec)
    m = int(nystrom_state.kpca.m)
    tol = 2 * checks.transform_tol(q[0], fsnap.X, fsnap.S, m, spec,
                                   torch.float32)[0]
    feat_ratio = float(((feats - plain).abs() / tol.clamp_min(1e-30))
                       .max())
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    # 127 ingests (Algorithm 2: 4 rotations, a k-row pass, a projection);
    # queries: 1 + 64 on the front, 2 around each of 3 publishes, 1 for
    # the batch (the tenant axis) + 4 single ones to hold it to, 1 feature
    # head.
    expect = {name: 0 for name in launches}
    expect.update(eigvec_rotate=4 * 127, krow_project=127,
                  eigvec_project=127, transform_project=1 + 64 + 6 + 5 + 1)
    ok = (stable and gens == [0, 1, 2, 3] and reuse == [True, True]
          and launches == expect
          and all(untouched) and batch_equal and feat_ratio <= 1.0
          and fsnap.S.shape == (512, 512))
    row = {"phase": "snapshots", "dtype": "float32", "capacity": capacity,
           "components": C, "front_stable_over_64_ingests": stable,
           "generations": gens, "third_publish_reuses_first": reuse,
           "retired_untouched": untouched, "query_batch_bitwise": batch_equal,
           "features_C": int(fsnap.S.shape[1]), "features_m": m,
           "features_err_over_2x_bound": feat_ratio,
           "seconds": time.perf_counter() - t0, "launches": launches}
    emit(row)
    if not ok:
        raise AssertionError(f"snapshots: {row}")
    return row


# ------------------------------------------------ self-healing stream --
def _leaves(torch, tree) -> list:
    return torch.utils._pytree.tree_leaves(tree)


def _bitwise(torch, a, b) -> bool:
    la, lb = _leaves(torch, a), _leaves(torch, b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _raised(fn):
    """What ``fn()`` raises (None when it returns), read from a future, so
    the script holds no handler of its own."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(fn).exception()


def _heal_readings(torch, hl, state) -> dict:
    """What the heal ladder's rule reads of ``state``: the exact
    orthogonality residual and the active spectrum's negative mass
    relative to its largest magnitude."""
    m = int(state.m)
    Lact = state.L[:m]
    lmax = max(float(Lact.abs().max()), 1e-30)
    return {"orth_residual": hl.exact_orth_residual(state),
            "neg_frac": max(0.0, float(-Lact.min())) / lmax}


def health_phase(torch, cuda, serve, points: int = 600, every: int = 97,
                 tilt_at: int = 150, negate_at: int = 350) -> dict:
    """``serve --mode kpca --health --metrics`` (f32 ``pallas``, capacity
    1024) with a non-finite point every ``every``-th point, U tilted off
    orthogonality before point ``tilt_at`` and an eigenvalue negated
    before point ``negate_at`` (all through ``kpca_service``'s
    ``on_point`` seam): each rejected point leaves the state bit for bit,
    the quarantine count is the injected count, each corruption is
    flagged within ⌈m/B⌉ probes, the healed stream ends on eigh within
    the f32 bars, the metric counters equal a host tally, and the
    launches are the unguarded route's (a rejected point runs its update
    on the stand-in).  The rungs are those the injections call for: the
    tilt, with the spectrum intact and a residual inside the polish band
    (``orth_tol`` < r ≤ ``polish_max``), is polished; the negated
    eigenvalue (negative mass above ``neg_tol``) is resynced.  The row
    prints the readings each heal saw; that the rule picks the
    reference's rung from such readings is held on the CPU against the
    JAX package (``tests/test_torch_health.py``)."""
    import numpy as np

    from repro_torch.core import health as hl
    from repro_torch.testing import faults

    args = serve.parse_args([
        "--mode", "kpca", "--device", "cuda", "--dtype", "float32",
        "--capacity", "1024", "--points", str(points), "--dim", "16",
        "--batch", "64", "--transform-every", "16", "--matmul", "pallas",
        "--health", "--metrics"])
    policy = hl.DEFAULT_POLICY
    syncs = {"accepted": [], "rejected": []}
    log = {"rejected_bitwise": [], "probes_to_flag": [], "flag_bound": [],
           "rungs": [], "readings": [], "heal_syncs": []}
    watch: dict = {}
    held = {"snap": None, "rejected": False}

    def on_point(i, stream, x):
        if i == 0:
            update, heal = stream.update, stream.heal

            def update_counted(x_new):
                kind = "rejected" if held["rejected"] else "accepted"
                return _count_syncs(torch, update, syncs[kind])(x_new)

            def heal_checked(level="auto"):
                log["readings"].append(_heal_readings(
                    torch, hl, stream.kpca_state))
                before = stream.metrics_report()
                out = _count_syncs(torch, heal, log["heal_syncs"])(
                    level=level)
                after = stream.metrics_report()
                log["rungs"].append(
                    "polish" if after["heals_polish"] > before["heals_polish"]
                    else "resync" if after["heals_resync"]
                    > before["heals_resync"] else "noop")
                return out

            stream.update, stream.heal = update_counted, heal_checked
        if held["snap"] is not None:
            log["rejected_bitwise"].append(
                _bitwise(torch, held["snap"], stream.state))
            held["snap"] = None
        for name, (p0, bound) in list(watch.items()):
            if not hl.is_healthy(stream.health, policy):
                log["probes_to_flag"].append(int(stream.health.probes) - p0)
                log["flag_bound"].append(bound)
                del watch[name]
        if i in (tilt_at, negate_at):
            st = stream.kpca_state
            m = stream.m
            if i == tilt_at:
                # Inside the polish band: residual ~ mag·sqrt(2m) ≈ 4e-3.
                stream.state = faults.corrupt_eigvecs(
                    st, magnitude=4e-3 / (2 * m) ** 0.5, seed=1)
            else:
                stream.state = faults.corrupt_eigenvalue(
                    st, 0, value=-float(st.L[:m].abs().max()))
            watch[i] = (int(stream.health.probes),
                        -(-m // policy.probe_cols))
        x = faults.nonfinite_every(every, i, x)
        held["rejected"] = not np.isfinite(x).all()
        if held["rejected"]:
            held["snap"] = [t.clone() for t in _leaves(torch, stream.state)]
        return x

    cuda.reset_launches()
    t0 = time.perf_counter()
    result, stream = serve.kpca_service(args, on_point=on_point)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    injected = points // every
    expect = {name: 0 for name in launches}
    expect.update(eigvec_rotate=4 * points, krow_project=points,
                  eigvec_project=points,
                  transform_project=points // args.transform_every)
    mets = result["metrics"]
    tally = {"ingests": points - injected, "rejections": injected,
             "evictions": 0, "downdates": 0,
             "heals_polish": log["rungs"].count("polish"),
             "heals_resync": log["rungs"].count("resync"),
             "m": float(4 + points - injected)}
    row = {"phase": "health", "dtype": "float32", "matmul": "pallas",
           "capacity": 1024, "points": points, "fault_every": every,
           "injected": injected, "quarantined": result["quarantined"],
           "rejected_bitwise": log["rejected_bitwise"],
           "probes_to_flag": log["probes_to_flag"],
           "flag_bound_probes": log["flag_bound"],
           "heals": result["heals"], "rungs": log["rungs"],
           "heal_readings": log["readings"],
           "metrics": {k: mets[k] for k in tally},
           "syncs_per_guarded_update": sum(syncs["accepted"])
           / max(1, len(syncs["accepted"])),
           "syncs_per_rejected_point": sum(syncs["rejected"])
           / max(1, len(syncs["rejected"])),
           "syncs_per_heal": log["heal_syncs"],
           "update_ms_p50": result["update_ms_p50"],
           "update_ms_p99": result["update_ms_p99"],
           "m_final": result["m_final"], "seconds": seconds,
           "launches": launches,
           **oracle_check(torch, stream.kpca_state, stream.spec, True,
                          "float32")}
    emit(row)
    ok = (result["quarantined"] == injected
          and log["rejected_bitwise"] == [True] * injected
          and len(log["probes_to_flag"]) == 2
          and all(p <= b for p, b in zip(log["probes_to_flag"],
                                         log["flag_bound"]))
          and log["rungs"] == ["polish", "resync"]
          and result["heals"] == 2 and len(log["readings"]) == 2
          and log["readings"][0]["neg_frac"] <= policy.neg_tol
          and (policy.orth_tol < log["readings"][0]["orth_residual"]
               <= policy.polish_max)
          and log["readings"][1]["neg_frac"] > policy.neg_tol
          and all(mets[k] == v for k, v in tally.items())
          and result["m_final"] == 4 + points - injected
          and launches == expect and result["finite"])
    if not ok:
        raise AssertionError(f"health: {row} (launches expected {expect}, "
                             f"tally {tally})")
    return row


def restore_phase(torch, cuda, capacity: int = 256, points: int = 100,
                  saved_at: int = 60, strike: int = 80) -> dict:
    """The restore rung: a guarded, metered f32 ``pallas`` stream saves a
    checkpoint (``checkpoint.npz_store`` in a temporary directory) at
    point ``saved_at``; at ``strike`` a stored row is poisoned, and the
    heal raises ``HealthError``; the last checkpoint loads, the tail is
    replayed, and the stream ends bit for bit equal to the uninterrupted
    run (state, health and metrics)."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.core import engine as eng, health as hl, inkpca
    from repro_torch.core import kernels_fn as kf
    from repro_torch.testing import faults

    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    plan = eng.UpdatePlan(matmul="pallas", fuse_krow=True,
                          dispatch="bucketed", health=hl.DEFAULT_POLICY,
                          metrics=True)
    X = torch.as_tensor(np.random.default_rng(6).normal(
        size=(4 + points, 16)), dtype=torch.float32, device="cuda")

    syncs: list = []

    def stream():
        s = inkpca.KPCAStream(X[:4], capacity, spec, plan=plan,
                              device="cuda")
        s.update = _count_syncs(torch, s.update, syncs)
        return s

    def lanes(s):
        return {"kpca": s.state, "health": s.health, "metrics": s.metrics}

    cuda.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ref = stream()
        for i in range(points):
            ref.update(X[4 + i])
            if i + 1 == saved_at:
                save_checkpoint(d, saved_at, lanes(ref))
            if i + 1 == strike:
                live = {k: [t.clone() for t in _leaves(torch, v)]
                        for k, v in lanes(ref).items()}
        back = stream()
        back.state = faults.poison_stored_row(
            type(ref.state)(*live["kpca"]), row=0)
        exc = _raised(back.heal)
        step = latest_step(d)
        out = load_checkpoint(d, step, lanes(back))
        back.state, back.health, back.metrics = (out["kpca"], out["health"],
                                                 out["metrics"])
        for i in range(step, points):
            back.update(X[4 + i])
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    updates = points + (points - saved_at)
    expect = {name: 0 for name in launches}
    expect.update(eigvec_rotate=4 * updates, krow_project=updates,
                  eigvec_project=updates)
    equal = _bitwise(torch, lanes(back), lanes(ref))
    row = {"phase": "restore", "dtype": "float32", "capacity": capacity,
           "points": points, "checkpoint_at": saved_at, "strike_at": strike,
           "raised": type(exc).__name__, "restored_step": step,
           "replay_bitwise": equal,
           "syncs_per_guarded_update": sum(syncs) / len(syncs),
           "seconds": time.perf_counter() - t0, "launches": launches}
    emit(row)
    if not (isinstance(exc, hl.HealthError) and step == saved_at and equal
            and launches == expect):
        raise AssertionError(f"restore: {row} (launches expected {expect})")
    return row


def guarded_window_phase(torch, cuda, serve, capacity: int = 256,
                         window: int = 200, points: int = 264,
                         every: int = 29) -> dict:
    """``serve --mode kpca --window 200 --health`` in f64 on the fused
    pair: a rejected point (growth or steady state) leaves the
    eigensystem, the arrival ring and the clock bit for bit; the window
    ends holding the last W accepted points in arrival order with
    consecutive ages, on eigh within the f64 bars; the launches are the
    unguarded window's for every offered point."""
    import numpy as np

    from repro_torch.testing import faults

    args = serve.parse_args([
        "--mode", "kpca", "--device", "cuda", "--dtype", "float64",
        "--capacity", str(capacity), "--window", str(window),
        "--points", str(points), "--dim", "16", "--batch", "64",
        "--transform-every", "16", "--matmul", "pallas2", "--health"])
    held = {"snap": None}
    untouched, syncs = [], []

    def on_point(i, stream, x):
        if i == 0:
            stream.update = _count_syncs(torch, stream.update, syncs)
        if held["snap"] is not None:
            untouched.append(_bitwise(torch, held["snap"], stream.state))
            held["snap"] = None
        x = faults.nonfinite_every(every, i, x)
        if not np.isfinite(x).all():
            held["snap"] = [t.clone() for t in _leaves(torch, stream.state)]
        return x

    cuda.reset_launches()
    t0 = time.perf_counter()
    result, stream = serve.kpca_service(args, on_point=on_point)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    growth, steady = result["growth_points"], result["steady_points"]
    expect = {"eigvec_rotate": 4 * growth + 8 * steady, "eigvec_rotate2": 0,
              "krow_project": points, "eigvec_project": points,
              "transform_project": points // args.transform_every,
              "scaled_gram": 0, "rbf_gram": 0, "flash_attention": 0,
              "flash_attention_bwd": 0,
              "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    expect.update(pair_reckoning(launches, 2 * growth + 4 * steady))
    x0, draws = serve.kpca_draws(args)
    kept = [x for i, (x, _) in enumerate(draws)
            if (i + 1) % every]
    accepted = np.concatenate([x0, np.stack(kept)])
    st = stream.kpca_state
    want = torch.as_tensor(accepted[-window:], dtype=st.X.dtype,
                           device=st.X.device)
    ages = stream.state.ages[:window].tolist()
    n = len(accepted)
    injected = points // every
    row = {"phase": "health_window", "dtype": "float64", "matmul": "pallas2",
           "capacity": capacity, "window": window, "points": points,
           "fault_every": every, "injected": injected,
           "quarantined": result["quarantined"],
           "rejected_untouched": untouched, "growth_points": growth,
           "steady_points": steady, "m_final": result["m_final"],
           "clock": int(stream.state.clock),
           "steady_update_ms_p50": result["steady_update_ms_p50"],
           "syncs_per_guarded_update": sum(syncs) / len(syncs),
           "seconds": seconds, "launches": launches,
           **oracle_check(torch, st, stream.spec, True, "float64")}
    emit(row)
    if not (result["quarantined"] == injected
            and untouched == [True] * injected
            and result["m_final"] == window
            and torch.equal(st.X[:window], want)
            and ages == list(range(n - window, n))
            and int(stream.state.clock) == n and launches == expect):
        raise AssertionError(f"health_window: {row} (launches expected "
                             f"{expect})")
    return row


def guarded_nystrom_phase(torch, cuda, serve, capacity: int = 256,
                          points: int = 500, every: int = 50) -> dict:
    """``serve --mode nystrom --health --metrics`` (f32, the fused pair):
    every ``every``-th point is made non-finite through
    ``nystrom_service``'s ``on_point`` seam, and each such row is dropped
    before it is observed or
    offered, the others are observed and admitted until the budget
    (capacity − 1) fills, and the trace error holds the f32 Nyström bar
    against the f64 recomputation."""
    from repro_torch.core import engine as eng
    from repro_torch.core import kernels_fn as kf
    from repro_torch.testing import faults

    args = serve.parse_args([
        "--mode", "nystrom", "--device", "cuda", "--dtype", "float32",
        "--capacity", str(capacity), "--points", str(points), "--dim", "16",
        "--matmul", "pallas2", "--health", "--metrics"])
    syncs: dict = {}
    undo = _offer_syncs(torch, eng.Engine, syncs)
    cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        result, state = serve.nystrom_service(
            args, on_point=lambda i, x: faults.nonfinite_every(every, i, x))
    finally:
        undo()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    injected = points // every
    rows = 4 + points - injected
    adm = min(points - injected, capacity - 1 - 4)
    expect = {name: 0 for name in launches}
    expect.update(krow_project=adm, **pair_reckoning(launches, adm))
    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    st = state.kpca
    m = result["m_final"]
    exact = exact_trace_error(torch, state.Xrows, st.X[:m], spec, capacity,
                              st.L.dtype)["f64"]
    rel = abs(result["trace_error"] - exact) / abs(exact)
    bar = NYSTROM_BARS["float32"]
    row = {"phase": "health_nystrom", "dtype": "float32",
           "capacity": capacity, "points": points, "fault_every": every,
           "injected": injected, "quarantined": result["quarantined"],
           "admitted": result["admitted"], "rows": result["rows"],
           "m_final": m, "trace_error": result["trace_error"],
           "trace_error_f64": exact, "trace_error_rel_err": rel,
           "bar_trace_rel_err": bar, "step_ms_p50": result["step_ms_p50"],
           "syncs_per_offer": {k: sum(v) / len(v) for k, v in syncs.items()},
           "seconds": seconds, "launches": launches}
    emit(row)
    if not (result["quarantined"] == injected and result["admitted"] == adm
            and result["rows"] == rows and m == 4 + adm and rel <= bar
            and result["finite"] and launches == expect):
        raise AssertionError(f"health_nystrom: {row} (launches expected "
                             f"{expect})")
    return row


def reproducible_phase(torch, cuda, capacity: int = 1024,
                       points: int = 48, every: int = 12) -> dict:
    """Two runs of one f32 ``pallas`` stream (capacity 1024, the fused
    prologue, bucketed) from one state end bit for bit equal, with the
    process in its default mode (``torch.use_deterministic_algorithms``
    off); so do a guarded run with and without the metric lane, with a
    non-finite point every ``every``-th.  The cluster merge's segment sums
    run on every rank-one update, so an order that varied would show in a
    short stream; the card test
    ``test_stream_runs_repeat_bit_for_bit_on_cuda`` runs 200 points at
    capacity 256."""
    import numpy as np

    from repro_torch.core import engine as eng, health as hl, inkpca
    from repro_torch.core import kernels_fn as kf
    from repro_torch.testing import faults

    spec = kf.KernelSpec(name="rbf", sigma=16.0)
    X = np.random.default_rng(7).normal(size=(4 + points, 16))
    poisoned = [faults.nonfinite_every(every, i, x)
                for i, x in enumerate(X[4:])]

    def run(xs, **lanes):
        s = inkpca.KPCAStream(
            torch.as_tensor(X[:4], dtype=torch.float32, device="cuda"),
            capacity, spec, plan=eng.UpdatePlan(
                matmul="pallas", fuse_krow=True, dispatch="bucketed",
                **lanes), device="cuda")
        for x in xs:
            s.update(x)
        torch.cuda.synchronize()
        return s

    deterministic = torch.are_deterministic_algorithms_enabled()
    cuda.reset_launches()
    t0 = time.perf_counter()
    a, b = run(X[4:]), run(X[4:])
    on = run(poisoned, health=hl.DEFAULT_POLICY, metrics=True)
    off = run(poisoned, health=hl.DEFAULT_POLICY)
    launches = dict(cuda.LAUNCHES)
    row = {"phase": "reproducible", "dtype": "float32", "matmul": "pallas",
           "capacity": capacity, "points": points,
           "deterministic_mode": deterministic,
           "two_runs_bitwise": _bitwise(torch, a.state, b.state),
           "metrics_on_off_bitwise": _bitwise(torch, on.state, off.state),
           "quarantined": on.health_report()["quarantined"],
           "seconds": time.perf_counter() - t0, "launches": launches}
    emit(row)
    if not (row["two_runs_bitwise"] and row["metrics_on_off_bitwise"]
            and not deterministic and row["quarantined"] == points // every
            and launches["eigvec_rotate"] == 16 * points):
        raise AssertionError(f"reproducible: {row}")
    return row


def batched_kernel_phase(torch, checks) -> dict:
    """The five kernels of the KPCA path over a tenant axis (B = 8, bucket
    1024, tenant b at m = 300 + 100 b, its own operands), f32 and f64: one
    launch each, held per entry to the batched plain version (each
    tenant's single plain call) within the kernel phase's bounds, each
    tenant bit for bit equal to the single launch on its operands, two
    runs bit for bit, f32 ``eigvec_rotate`` within ``TF32_ERR_RATIO`` of
    the plain f32 error against f64."""
    t0 = time.perf_counter()
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for case in checks.batched_cases(MAIN_N, TENANT_MS, dtype, "cuda"):
            res = checks.compare(case)
            if case.exact is not None and dtype == torch.float32:
                res.update(checks.error_vs_exact(case),
                           bar_err_ratio=TF32_ERR_RATIO)
            res["bitwise_vs_single"] = checks.batched_bitwise(case)
            res["repeats_bitwise"] = checks.repeats_bitwise(case)
            row = {"phase": "kernels", "name": case.name,
                   "variant": case.variant,
                   "dtype": str(dtype).removeprefix("torch."), "n": MAIN_N,
                   "m": list(TENANT_MS), "tenants": case.tenants, **res}
            emit(row)
            if not (row["bitwise_vs_single"] and row["repeats_bitwise"]
                    and row.get("err_ratio", 0.0) <= TF32_ERR_RATIO):
                raise AssertionError(f"batched {case.name}: {row}")
            rows[case.name, row["dtype"]] = row
    emit_total("kernels_batched", t0, len(rows))
    return rows


def batched_timing_phase(torch, checks) -> dict:
    """Each batched kernel's device time beside the B single launches'
    (the loop it replaces), its plain version's, the library's batched
    call's (``checks.queued_ms``, as in ``timing_phase``) and its bound,
    at the batched kernel phase's shapes."""
    t_phase = time.perf_counter()
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for case in checks.batched_cases(MAIN_N, TENANT_MS, dtype, "cuda"):
            t0 = time.perf_counter()
            ms, per_call = checks.device_ms(case.kernel, reps=BATCHED_REPS)
            singles_ms, singles_per_call = checks.device_ms(
                case.loop, reps=BATCHED_REPS)
            bound_ms, bound_by = case.bound(dtype)
            row = {"phase": "timing", "name": case.name,
                   "variant": case.variant,
                   "dtype": str(dtype).removeprefix("torch."), "n": MAIN_N,
                   "m": list(TENANT_MS), "tenants": case.tenants, "ms": ms,
                   "timed_by": ("profiler" if per_call is not None
                                else "queued events"),
                   "device_launches_per_call": per_call,
                   "singles_ms": singles_ms,
                   "singles_device_launches": singles_per_call,
                   "call_ms": checks.call_ms(case.kernel),
                   "singles_call_ms": checks.call_ms(case.loop),
                   "plain_ms": checks.device_ms(case.plain,
                                                reps=PLAIN_REPS)[0],
                   "library_ms": (checks.queued_ms(case.library)
                                  if case.library else None),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "seconds": time.perf_counter() - t0}
            emit(row)
            rows[case.name, row["dtype"]] = row
    emit_total("timing_batched", t_phase, len(rows))
    return rows


def _cohort_steps(torch, cuda, batch, xs) -> dict:
    """A cohort's steps at one bucket: (1) wall ms per step, host clock
    around each synchronised step, and its kernel launches per step; (2)
    the synchronizing calls per step (torch's sync debug mode); (3) device
    launches and busy ms per step under the profiler, as
    ``launch/profile_update.py`` counts them.  ``xs`` (3 n + 2, B, d) on
    the card: n steps a pass after 2 warm-up steps."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = (xs.shape[0] - 2) // 3
    m_start = int(batch._m_host.min())
    for x in xs[:2]:
        batch.update(x)
    torch.cuda.synchronize()
    before = dict(cuda.LAUNCHES)
    ms = []
    for x in xs[2:2 + n]:
        t0 = time.perf_counter()
        batch.update(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    kernel_launches = {k: (v - before[k]) / n for k, v in cuda.LAUNCHES.items()
                       if v != before[k]}
    syncs: list = []
    step = _count_syncs(torch, batch.update, syncs)
    for x in xs[2 + n:2 + 2 * n]:
        step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs[2 + 2 * n:]:
            batch.update(x)
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    busy = sum(dev) / 1e3 / n
    p50 = float(np.median(ms))
    return {"tenants": batch.n_tenants, "steps": n,
            "m_start": m_start,
            "step_ms_p50": p50, "step_ms_max": float(max(ms)),
            "aggregate_updates_per_s": batch.n_tenants / (p50 / 1e3),
            "kernel_launches_per_step": kernel_launches,
            "syncs_per_step": sum(syncs) / n,
            "device_launches_per_step": len(dev) / n,
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / p50}


def multitenant_phase(torch, cuda, serve, points: int = 600,
                      reckon_steps: int = 10) -> dict:
    """``serve --mode kpca --tenants 8 --cohorts max`` (f32 ``pallas``, the
    fused prologue, bucketed, capacity 1024, d = 16, 4 + ``points``
    points a tenant, 64 queries x 8 components every 16 points): each
    kernel launched once a step for the cohort (the single stream's
    reckoning), the synchronizing calls inside the steps only at bucket
    crossings, every tenant's top-8 eigenpairs against f64 eigh of its own
    gram (the f32 bars).  Then the same stream at B = 1 (tenant 0) and
    B = 8, ``reckon_steps`` steps each at the top bucket: kernel launches
    per step equal, device launches per step within 10 %, no
    synchronizing call, and the aggregate updates/s of both."""
    from repro_torch.core import engine as eng, inkpca

    args = serve.parse_args([
        "--mode", "kpca", "--device", "cuda", "--dtype", "float32",
        "--tenants", str(TENANTS), "--cohorts", "max", "--capacity", "1024",
        "--points", str(points), "--dim", "16", "--batch", "64",
        "--transform-every", "16", "--matmul", "pallas"])
    syncs: list = []
    orig = eng.StreamBatch.update
    eng.StreamBatch.update = (lambda self, *a, **k: _count_syncs(
        torch, orig, syncs)(self, *a, **k))
    cuda.reset_launches()
    t0 = time.perf_counter()
    result, batch = serve.kpca_multitenant_service(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    eng.StreamBatch.update = orig
    launches = dict(cuda.LAUNCHES)
    expect = {"eigvec_rotate": 4 * points, "eigvec_rotate2": 0,
              "krow_project": points, "eigvec_project": points,
              "transform_project": points // args.transform_every,
              "scaled_gram": 0, "rbf_gram": 0, "flash_attention": 0,
              "flash_attention_bwd": 0,
              "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    # A step of tenants at m needs m + 1 rows: the cohort crosses into
    # buckets 256, 512 and 1024 at the steps where 4 + i + 1 passes 128,
    # 256 and 512; only there may a step read m back.
    crossings = {b - 4 for b in (128, 256, 512)}
    sync_steps = sorted(i for i, s in enumerate(syncs) if s)
    oracle = [oracle_check(torch, batch.state_of(i), batch.spec, True,
                           "float32") for i in range(TENANTS)]
    reckon = {}
    rng = __import__("numpy").random.default_rng(3)
    xs = torch.as_tensor(rng.normal(size=(3 * reckon_steps + 2, TENANTS,
                                          16)),
                         dtype=torch.float32, device="cuda")
    for B in (1, TENANTS):
        states = batch.states if B == TENANTS else inkpca.stack_states(
            [batch.state_of(0)])
        cohort = eng.StreamBatch.from_states(states, batch.spec,
                                             plan=batch.plan)
        reckon[B] = _cohort_steps(torch, cuda, cohort, xs[:, :B].contiguous())
    one, many = reckon[1], reckon[TENANTS]
    ratio = many["device_launches_per_step"] / one["device_launches_per_step"]
    row = {"phase": "multitenant", "dtype": "float32", "matmul": "pallas",
           "cohorts": "max", "tenants": TENANTS, "capacity": 1024,
           "points": points, "m_final": result["m_final"],
           **{k: result[k] for k in ("step_ms_p50", "step_ms_p90",
                                     "step_ms_p99", "step_ms_max",
                                     "query_ms_p50", "query_ms_p99",
                                     "aggregate_updates_per_s",
                                     "transforms_served", "total_s")},
           "seconds": seconds, "launches": launches,
           "sync_steps": sync_steps, "syncs": sum(syncs),
           "top8_eig_rel_err": max(o["top8_eig_rel_err"] for o in oracle),
           "top8_subspace_min_cos": min(o["top8_subspace_min_cos"]
                                        for o in oracle),
           "bar_rel_err": BARS["float32"][0],
           "bar_min_cos": BARS["float32"][1],
           "reckoning": {str(B): r for B, r in reckon.items()},
           "device_launch_ratio": ratio}
    emit(row)
    if not (launches == expect and result["finite"]
            and result["m_final"] == [4 + points] * TENANTS
            and set(sync_steps) <= crossings
            and one["kernel_launches_per_step"]
            == many["kernel_launches_per_step"]
            and abs(ratio - 1.0) <= 0.10
            and one["syncs_per_step"] == many["syncs_per_step"] == 0):
        raise AssertionError(f"multitenant: {row} (launches expected "
                             f"{expect}, syncs only at {sorted(crossings)})")
    return row, batch.state_of(0)


def multitenant_cohorts_phase(torch, cuda, steps: int = 64,
                              block: int = 6) -> dict:
    """The grouped geometries on the fused pair (f64 ``pallas2``, the fused
    prologue, capacity 256, buckets from 64, B = 6): tenant i steps when
    step % (i + 1) == 0 (the reference's cohort test), then a ``block``-
    step block; ``bucket`` then ``bucket-padded``.  More than one group
    forms; every tenant equals its own single ``KPCAStream`` fed the same
    points on the card within 1e-9 (eigenvalues) and 1e-8
    (reconstruction); idle tenants stay bit for bit."""
    import numpy as np

    from repro_torch.core import engine as eng, inkpca, kernels_fn as kf
    from repro_torch.core import rankone

    B, d, cap = 6, 16, 256
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    plan = eng.UpdatePlan(matmul="pallas2", fuse_krow=True,
                          dispatch="bucketed", min_bucket=64)
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(B, 4, d))
    xs = rng.normal(size=(steps, B, d))
    masks = [np.array([t % (i + 1) == 0 for i in range(B)])
             for t in range(steps)]
    blk = rng.normal(size=(block, B, d))
    dev = dict(dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    singles = [inkpca.KPCAStream(torch.as_tensor(x0[i], **dev), cap, spec,
                                 plan=plan, dtype=torch.float64,
                                 device="cuda") for i in range(B)]
    for t in range(steps):
        for i, s in enumerate(singles):
            if masks[t][i]:
                s.update(xs[t, i])
    for i, s in enumerate(singles):
        s.update_block(blk[:, i])
    single_s = time.perf_counter() - t0
    xs_dev, blk_dev = (torch.as_tensor(a, **dev) for a in (xs, blk))
    out = {}
    for cohorts in ("bucket", "bucket-padded"):
        batch = eng.StreamBatch(torch.as_tensor(x0, **dev), cap, spec,
                                plan=plan, dtype=torch.float64,
                                cohorts=cohorts, device="cuda")
        cuda.reset_launches()
        t0 = time.perf_counter()
        idle_bitwise, groups = [], 0
        for t in range(steps):
            check = t in (9, 33, 57)
            idle = np.nonzero(~masks[t])[0] if check else []
            before = {i: batch.state_of(int(i)) for i in idle}
            batch.update(xs_dev[t], active=masks[t])
            groups = max(groups, len(batch._groups))
            idle_bitwise += [_bitwise(torch, batch.state_of(int(i)), st)
                             for i, st in before.items()]
        batch.update_block(blk_dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        sts = batch.states
        err_l = err_r = 0.0
        for i, s in enumerate(singles):
            ref = s.kpca_state
            m = int(ref.m)
            if int(sts.m[i]) != m:
                raise AssertionError(f"{cohorts}: tenant {i} m "
                                     f"{int(sts.m[i])} != {m}")
            err_l = max(err_l, float((sts.L[i, :m] - ref.L[:m]).abs().max()))
            err_r = max(err_r, float((rankone.reconstruct(
                sts.L[i], sts.U[i], sts.m[i]) - rankone.reconstruct(
                    ref.L, ref.U, ref.m)).abs().max()))
        row = {"phase": "multitenant_cohorts", "cohorts": cohorts,
               "dtype": "float64", "matmul": "pallas2", "tenants": B,
               "capacity": cap, "min_bucket": plan.min_bucket,
               "steps": steps, "block": block,
               "m_final": sts.m.tolist(), "groups_max": groups,
               "eig_max_abs_err": err_l, "recon_max_abs_err": err_r,
               "bars": [1e-9, 1e-8], "idle_checked": len(idle_bitwise),
               "idle_bitwise": all(idle_bitwise), "seconds": seconds,
               "singles_seconds": single_s,
               "launches": dict(cuda.LAUNCHES)}
        emit(row)
        if not (groups > 1 and err_l <= 1e-9 and err_r <= 1e-8
                and idle_bitwise and all(idle_bitwise)
                and bool(torch.isfinite(sts.L).all())):
            raise AssertionError(f"multitenant_cohorts: {row}")
        out[cohorts] = row
    return out


def multitenant_window_phase(torch, cuda, serve, window: int = 200,
                             points: int = 264) -> dict:
    """``serve --tenants 4 --window 200 --health --metrics`` (f64
    ``pallas``, capacity 256, 264 points a tenant), cohorts ``max`` and
    ``bucket``, a non-finite point injected into lane 1 at step W / 2
    (growing) and lane 3 at step W + 30 (at the window), through the
    service's ``on_step`` seam: the rejected lane's state bit for bit
    untouched while the others advance, each tenant's rows its last W
    accepted points, its eigensystem against f64 eigh (the f64 bars), the
    quarantine tally and the metric lanes equal to a host tally."""
    import numpy as np

    B = 4
    bad = {window // 2: 1, window + 30: 3}
    out = {}
    for cohorts in ("max", "bucket"):
        args = serve.parse_args([
            "--mode", "kpca", "--device", "cuda", "--dtype", "float64",
            "--tenants", str(B), "--cohorts", cohorts, "--capacity", "256",
            "--window", str(window), "--points", str(points), "--dim", "16",
            "--batch", "64", "--transform-every", "16", "--matmul",
            "pallas", "--health", "--metrics"])
        log, checks_ok = {}, []

        def on_step(i, batch, xs):
            if i - 1 in bad:
                lane, st, ingested = log[i - 1]
                moved = batch._ingest_host - ingested
                checks_ok.append(
                    _bitwise(torch, batch.state_of(lane), st)
                    and moved[lane] == 0
                    and all(moved[j] == 1 for j in range(B) if j != lane))
            if i in bad:
                xs = np.array(xs)
                xs[bad[i], 0] = np.nan
                log[i] = (bad[i], batch.state_of(bad[i]),
                          batch._ingest_host.copy())
            return xs

        cuda.reset_launches()
        t0 = time.perf_counter()
        result, batch = serve.kpca_multitenant_service(args, on_step=on_step)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        x0, steps = serve.multitenant_draws(args)
        rows_ok, oracle = [], []
        for b in range(B):
            acc = [x[b] for i, (x, _) in enumerate(steps)
                   if bad.get(i) != b]
            last = np.concatenate([x0[b], np.stack(acc)])[-window:]
            st = batch.state_of(b)
            rows_ok.append(torch.equal(st.X[:window], torch.as_tensor(
                last, dtype=st.X.dtype, device=st.X.device)))
            oracle.append(oracle_check(torch, st, batch.spec, True,
                                       "float64"))
        rejected = np.array([sum(v == b for v in bad.values())
                             for b in range(B)])
        ingests = points - rejected
        met = result["metrics"]
        tally = {"ingests": ingests.tolist(),
                 "rejections": rejected.tolist(),
                 "evictions": (ingests - (window - 4)).tolist(),
                 "m": [float(window)] * B}
        lanes = {k: met[k] for k in tally}
        row = {"phase": "multitenant_window", "cohorts": cohorts,
               "dtype": "float64", "matmul": "pallas", "tenants": B,
               "capacity": 256, "window": window, "points": points,
               "injected": {str(k): v for k, v in bad.items()},
               "rejected_untouched": checks_ok, "rows_last_w": rows_ok,
               "quarantined": result["quarantined"],
               "quarantined_per_tenant": batch.quarantined.tolist(),
               "metric_lanes": lanes, "tally": tally,
               "top8_eig_rel_err": max(o["top8_eig_rel_err"]
                                       for o in oracle),
               "top8_subspace_min_cos": min(o["top8_subspace_min_cos"]
                                            for o in oracle),
               "step_ms_p50": result["step_ms_p50"], "seconds": seconds,
               "launches": dict(cuda.LAUNCHES)}
        emit(row)
        if not (len(checks_ok) == len(bad) and all(checks_ok)
                and all(rows_ok) and result["quarantined"] == len(bad)
                and batch.quarantined.tolist() == rejected.tolist()
                and lanes == tally and result["finite"]
                and result["m_final"] == [window] * B):
            raise AssertionError(f"multitenant_window: {row}")
        out[cohorts] = row
    return out


# ------------------------------ decoupled serving, the sharded update --
DECOUPLED_POINTS, DECOUPLED_EVERY, DECOUPLED_RATE = 600, 4, 2
FAULT_TILT, FAULT_POISON = 5, 3      # the fault run's tenants


def _decoupled_args(serve, *extra) -> list:
    return ["--mode", "kpca", "--decouple", "--device", "cuda", "--dtype",
            "float32", "--tenants", str(TENANTS), "--capacity", "1024",
            "--dim", "16", "--batch", "64", "--serve-components", "8",
            "--matmul", "pallas", *extra]


def _recording_query(serve, log: list):
    """Wrap ``IngestServeLoop.query`` to log (snapshots read, queries,
    answers); returns the original to restore."""
    orig = serve.IngestServeLoop.query

    def query(self, q):
        y = orig(self, q)
        log.append((self.snaps, q, y))
        return y

    serve.IngestServeLoop.query = query
    return orig


def _drift_reckoning(published: list, every: int, probe_every: int) -> int:
    """The drift probes ``IngestServeLoop`` must run, from the steps at
    which it published: the cadence first, else a probe every
    ``probe_every``-th non-publishing step, the count restarting at each
    publication."""
    since = since_probe = probes = 0
    for pub in published:
        since += 1
        if since < every:
            since_probe += 1
            if since_probe >= probe_every:
                since_probe = 0
                probes += 1
        if pub:
            since = since_probe = 0
    return probes


def decoupled_phase(torch, cuda, serve) -> dict:
    """``serve --mode kpca --decouple`` at full width: 8 tenants, capacity
    1024, f32 ``pallas``, d = 16, 4 + 600 points, 2 query batches of 64 a
    step, republished every 4 steps, ``--health``: 150 generations, every
    answer bit for bit ``serving.query_batch`` on the snapshot it read,
    every tenant's top-8 against f64 eigh, launches to the reckoning.
    Then a ``--publish-on-drift 0.05 --drift-probe-every 4 --serve-every
    64`` run (200 points): the probes that ran equal the count the loop's
    rule gives for the publications that happened (drift publications are
    reported, not gated: the stream is i.i.d.).  Then a fault run through
    ``on_step`` (64 points, every 4): tenant 5 tilted at step 20 (healed at
    the next publication, which then goes ahead), tenant 3 poisoned beyond
    repair (U and a stored row) at step 40: every later publication
    refused, the generation frozen, the answers finite and bit for bit the
    frozen snapshot's."""
    from repro_torch.core import serving
    from repro_torch.core.inkpca import unstack_state
    from repro_torch.testing import faults

    log: list = []
    args = serve.parse_args(_decoupled_args(
        serve, "--points", str(DECOUPLED_POINTS), "--query-rate",
        str(DECOUPLED_RATE), "--serve-every", str(DECOUPLED_EVERY),
        "--health"))
    orig = _recording_query(serve, log)
    cuda.reset_launches()
    t0 = time.perf_counter()
    result, loop = serve.kpca_decoupled_service(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    serve.IngestServeLoop.query = orig
    launches = dict(cuda.LAUNCHES)
    n = DECOUPLED_POINTS
    expect = {"eigvec_rotate": 4 * n, "eigvec_rotate2": 0,
              "krow_project": n, "eigvec_project": n,
              "transform_project": n * DECOUPLED_RATE, "scaled_gram": 0,
              "rbf_gram": 0, "flash_attention": 0,
              "flash_attention_bwd": 0, "ssd_intra_chunk": 0,
              "ssd_intra_chunk_bwd": 0}
    bitwise = all(torch.equal(y, serving.query_batch(s, q, spec=loop.spec,
                                                     plan=loop.plan))
                  for s, q, y in log)
    gens = sorted({int(s.generation[0]) for s, _, _ in log})
    oracle = [oracle_check(torch, loop.batch.state_of(i), loop.spec, True,
                           "float32") for i in range(TENANTS)]
    del log[:]

    # The drift trigger, rate-limited.
    published: list = []
    dargs = serve.parse_args(_decoupled_args(
        serve, "--points", "200", "--query-rate", "1", "--serve-every",
        "64", "--publish-on-drift", "0.05", "--drift-probe-every", "4"))
    pub = serve.IngestServeLoop._publish_due
    serve.IngestServeLoop._publish_due = (
        lambda self: published.append(pub(self)) or published[-1])
    dres, _ = serve.kpca_decoupled_service(dargs)
    serve.IngestServeLoop._publish_due = pub
    reckoned = _drift_reckoning(published, 64, 4)

    # Faults through the seam.
    frozen: dict = {}

    def on_step(i, batch, xs):
        if i in (20, 40):
            batch._flush()
            full = batch._full
            U, X = full.U.clone(), full.X.clone()
            if i == 20:          # into the polish band (m = 24): heals
                U[FAULT_TILT] = faults.corrupt_eigvecs(
                    unstack_state(full, FAULT_TILT),
                    magnitude=4e-3 / 48 ** 0.5, seed=1).U
            else:                # beyond repair: U and a stored row
                U[FAULT_POISON, :, 0] = float("nan")
                X[FAULT_POISON, 0, 0] = float("nan")
            batch._full = full._replace(U=U, X=X)
        return xs

    fargs = serve.parse_args(_decoupled_args(
        serve, "--points", "64", "--query-rate", "1", "--serve-every", "4",
        "--health"))
    orig = _recording_query(serve, log)
    fres, floop = serve.kpca_decoupled_service(fargs, on_step=on_step)
    serve.IngestServeLoop.query = orig
    frozen_gen = int(floop.snaps.generation[0])
    late = [(s, q, y) for i, (s, q, y) in enumerate(log) if i >= 44]
    stale_ok = all(s is floop.snaps and bool(torch.isfinite(y).all())
                   and torch.equal(y, serving.query_batch(
                       s, q, spec=floop.spec, plan=floop.plan))
                   for s, q, y in late)
    del log[:]

    keep = ("generations", "skipped_publishes", "heals", "drift_probes",
            "drift_publishes", "quarantined", "ingest_ms_p50",
            "ingest_ms_p99", "query_ms_p50", "query_ms_p99",
            "publish_ms_p50", "publish_ms_p99", "queries_served", "total_s")
    row = {"phase": "decoupled", "dtype": "float32", "matmul": "pallas",
           "tenants": TENANTS, "capacity": 1024, "points": n,
           "query_rate": DECOUPLED_RATE, "serve_every": DECOUPLED_EVERY,
           "seconds": seconds, **{k: result[k] for k in keep},
           "m_final": result["m_final"], "launches": launches,
           "answers_bitwise_query_batch": bitwise,
           "generations_read": [gens[0], gens[-1], len(gens)],
           "top8_eig_rel_err": max(o["top8_eig_rel_err"] for o in oracle),
           "top8_subspace_min_cos": min(o["top8_subspace_min_cos"]
                                        for o in oracle),
           "drift": {k: dres[k] for k in ("generations", "drift_probes",
                                          "drift_publishes")},
           "drift_probes_reckoned": reckoned,
           "faults": {k: fres[k] for k in ("generations",
                                           "skipped_publishes", "heals")},
           "faults_frozen_generation": frozen_gen,
           "faults_stale_answers_ok": stale_ok}
    emit(row)
    bar_rel, bar_cos = BARS["float32"]
    if not (result["generations"] == n // DECOUPLED_EVERY
            and result["skipped_publishes"] == 0 and bitwise
            and launches == expect and result["finite"]
            and result["m_final"] == [4 + n] * TENANTS
            and row["top8_eig_rel_err"] <= bar_rel
            and row["top8_subspace_min_cos"] >= bar_cos
            and dres["drift_probes"] == reckoned
            and fres["heals"] >= 1 and fres["generations"] == 10
            and fres["skipped_publishes"] == 64 - 43
            and frozen_gen == 10 and stale_ok and len(late) == 20):
        raise AssertionError(f"decoupled: {row} (launches expected "
                             f"{expect})")
    return row


SHARD_UPDATES, SHARD_STEPS, SHARD_GUARDED = 100, 100, 50


def _unit_rows(rng, n: int, m: int, M: int, scale: float):
    """n vectors of norm ``scale`` on the first m entries, zero past."""
    import numpy as np

    V = np.zeros((n, M))
    V[:, :m] = rng.normal(size=(n, m))
    return V * (scale / np.linalg.norm(V, axis=1, keepdims=True))


def sharded_jobs(torch, state0, *, p_tenant: int) -> tuple[list, dict]:
    """The sharded phases' jobs (the same for P = 1 and P = 2) and what
    their checks need.  ``state0``: tenant 0 of the multi-tenant phase (f32,
    capacity 1024, m = 604 after 600 points)."""
    import numpy as np

    from repro_torch.core import inkpca, kernels_fn as kf, window as wnd

    rng = np.random.default_rng(11)
    M = state0.L.shape[0]
    m = int(state0.m)
    lmax = float(state0.L[:m].abs().max())
    # 100 updates of norm² 0.3·λmax with alternating signs, and 100 ±σ
    # pairs of the same size.
    V = _unit_rows(rng, SHARD_UPDATES, m, M, (0.3 * lmax) ** 0.5)
    S = np.where(np.arange(SHARD_UPDATES) % 2, -0.5, 1.0)
    V1 = _unit_rows(rng, SHARD_UPDATES, m, M, (0.3 * lmax) ** 0.5)
    V2 = _unit_rows(rng, SHARD_UPDATES, m, M, (0.3 * lmax) ** 0.5)
    S1 = rng.uniform(0.5, 1.0, size=SHARD_UPDATES)
    f32 = dict(dtype=torch.float32)
    jobs = [dict(kind="update", plan={"matmul": "pallas",
                                      "dispatch": "bucketed"},
                 L=state0.L.cpu(), U=state0.U.cpu(),
                 V=torch.tensor(V, **f32), S=torch.tensor(S, **f32),
                 m=state0.m.cpu()),
            dict(kind="pair", plan={"matmul": "pallas2",
                                    "dispatch": "bucketed"},
                 L=state0.L.cpu(), U=state0.U.cpu(),
                 V1=torch.tensor(V1, **f32), S1=torch.tensor(S1, **f32),
                 V2=torch.tensor(V2, **f32), S2=torch.tensor(-S1, **f32),
                 m=state0.m.cpu())]
    # Windows: full windows built by eigh of their points (unadjusted),
    # arrival order = row order.
    d = 16
    spec = kf.KernelSpec(name="rbf", sigma=float(d))
    windows = {}
    for key, (cap, W, dtype, T, plan) in {
            "window_f32": (1024, 1000, torch.float32, SHARD_STEPS,
                           {"matmul": "pallas", "fuse_krow": True,
                            "dispatch": "bucketed"}),
            "window_f64_guarded": (256, 200, torch.float64, SHARD_GUARDED,
                                   {"matmul": "pallas2", "fuse_krow": True,
                                    "dispatch": "bucketed",
                                    "health": True})}.items():
        pts = rng.normal(size=(W, d))
        st = inkpca.init_state(torch.tensor(pts, dtype=torch.float64,
                                            device="cuda"), cap, spec,
                               adjusted=False, dtype=dtype)
        ages = torch.full((cap,), wnd.age_sentinel(), dtype=torch.int64)
        ages[:W] = torch.arange(W)
        xs = rng.normal(size=(T, d))
        if plan.get("health"):
            xs[5::10, 3] = np.nan          # every 10th point poisoned
        windows[key] = dict(points=pts, xs=xs, W=W, plan=plan, spec=spec)
        jobs.append(dict(kind="window", sigma=float(d), plan=plan,
                         L=st.L.cpu(), U=st.U.cpu(), X=st.X.cpu(), ages=ages,
                         clock=torch.tensor(W, dtype=torch.int64),
                         xs=torch.tensor(xs, dtype=dtype), m=st.m.cpu()))
    # A block of poison: the state bit for bit.
    g = jobs[-1]
    jobs.append(dict(g, xs=torch.full((3, d), float("nan"),
                                      dtype=torch.float64)))
    mesh = f"{p_tenant}x1"
    jobs.append(dict(kind="decoupled", mesh=(p_tenant, 1), argv=[
        "--mode", "kpca", "--decouple", "--mesh", mesh, "--device", "cuda",
        "--dtype", "float32", "--tenants", str(TENANTS), "--capacity", "256",
        "--points", "40", "--dim", "16", "--batch", "16", "--query-rate",
        "1", "--serve-every", "4", "--serve-components", "8", "--matmul",
        "pallas"]))
    return jobs, {"V": V, "S": S, "V1": V1, "V2": V2, "S1": S1,
                  "windows": windows}


def _eigh_check(torch, L, U, K, m: int) -> dict:
    """Top-8 of (L, U) against f64 eigh of the dense target K (m × m)."""
    lam_ref, vec_ref = torch.linalg.eigh(K)
    lam_ref, vec_ref = lam_ref.flip(0)[:8], vec_ref.flip(1)[:, :8]
    order = torch.argsort(torch.where(torch.arange(L.shape[0],
                                                   device=L.device) < m,
                                      -L, torch.inf))[:8]
    lam, vec = L[order].double(), U[:m, order].double()
    rel = float(((lam - lam_ref).abs() / lam_ref.abs()).max())
    cos = float(torch.linalg.svdvals(vec_ref.T @ vec).min())
    return {"top8_eig_rel_err": rel, "top8_subspace_min_cos": cos}


def sharded_checks(torch, state0, jobs, aux, outs_by_rank, single=None
                   ) -> dict:
    """Hold one run of ``sharded_jobs`` (each rank's outputs) to the
    oracles: f32 updates, pairs and window against f64 eigh at the
    service bars (the window's rows also its last W points in arrival
    order); the f64 guarded window against the local ``Engine`` path
    within 1e-10 of λmax (U within 1e-8), rejected points left out, a
    poisoned block bit for bit; with ``single`` (the P = 1 run's outputs)
    the decoupled mesh's answers against it for the same tenants."""
    import numpy as np

    from repro_torch.core import engine as eng, health as hl
    from repro_torch.core import inkpca, kernels_fn as kf
    from repro_torch.core import window as wnd

    dev = "cuda"
    f64 = {"dtype": torch.float64, "device": dev}
    P = len(outs_by_rank)

    def whole(j, key="U"):
        return torch.cat([o[j][key] for o in outs_by_rank], dim=-2).to(dev)

    r0 = outs_by_rank[0]
    m = int(state0.m)
    out = {}
    bar_rel, bar_cos = BARS["float32"]
    # Updates and pairs: the dense f64 target.
    K0 = ((state0.U[:m, :m].double() * state0.L[:m].double())
          @ state0.U[:m, :m].double().T)
    Kup, Kpair = K0.clone(), K0.clone()
    V = torch.tensor(aux["V"][:, :m], device=dev)
    for v, s in zip(V, aux["S"]):
        Kup += float(s) * torch.outer(v, v)
    V1 = torch.tensor(aux["V1"][:, :m], device=dev)
    V2 = torch.tensor(aux["V2"][:, :m], device=dev)
    for v1, v2, s in zip(V1, V2, aux["S1"]):
        Kpair += float(s) * (torch.outer(v1, v1) - torch.outer(v2, v2))
    for j, (name, K) in enumerate((("updates", Kup), ("pairs", Kpair))):
        out[name] = _eigh_check(torch, r0[j]["L"].to(dev), whole(j), K, m)
    # The f32 window.
    w = aux["windows"]["window_f32"]
    j = 2
    W = w["W"]
    seq = np.concatenate([w["points"], w["xs"]])[-W:]
    ages = r0[j]["ages"][:W]
    X = r0[j]["X"][:W].double().numpy()
    rows_ok = bool(np.array_equal(X[np.argsort(ages.numpy())],
                                  seq.astype(np.float32).astype(np.float64)))
    Xw = torch.tensor(seq, device=dev)
    Kw = kf.gram_block(Xw, Xw, spec=w["spec"])
    out["window_f32"] = {**_eigh_check(torch, r0[j]["L"].to(dev), whole(j),
                                       Kw, W), "rows_in_order": rows_ok}
    # The guarded f64 window against the local Engine path.
    g = aux["windows"]["window_f64_guarded"]
    j = 3
    job = jobs[j]
    plan = eng.UpdatePlan(matmul="pallas2", fuse_krow=True,
                          dispatch="bucketed", window=g["W"],
                          health=hl.DEFAULT_POLICY)
    engine = eng.Engine(g["spec"], plan, adjusted=False)
    st = inkpca.KPCAState(L=job["L"].to(dev), U=job["U"].to(dev),
                          m=job["m"].to(dev), S=torch.zeros((), **f64),
                          K1=torch.zeros(job["L"].shape[0], **f64),
                          X=job["X"].to(dev))
    stream = eng.make_stream(wnd.WindowState(st, job["ages"].to(dev),
                                             job["clock"].to(dev)),
                             health=hl.init_health(torch.float64, dev))
    stream = engine.step_block(stream, job["xs"].to(dev), window=g["W"])
    Lg, Ug = r0[j]["L"].to(dev), whole(j)
    lmax = float(stream.kpca.L[:g["W"]].abs().max())
    accepted = int(np.isfinite(g["xs"]).all(axis=1).sum())
    out["window_f64_guarded"] = {
        "L_err_over_lmax": float((Lg - stream.kpca.L).abs()[:g["W"]].max())
        / lmax,
        "U_err": float((Ug - stream.kpca.U).abs().max()),
        "clock_advance": int(r0[j]["clock"]) - g["W"],
        "accepted": accepted,
        "ages_equal": bool(torch.equal(r0[j]["ages"].to(dev), stream.ages))}
    j = 4
    out["poisoned_block_bitwise"] = bool(
        torch.equal(r0[j]["L"], jobs[j]["L"])
        and torch.equal(whole(j).cpu(), jobs[j]["U"])
        and all(torch.equal(r0[j][k], jobs[j][k])
                for k in ("X", "ages", "clock")))
    # The decoupled service on the mesh.
    j = 5
    dec = r0[j]["result"]
    out["decoupled"] = {k: dec[k] for k in ("generations", "m_final",
                                            "queries_served",
                                            "tenant_sharded_queries")}
    if single is not None:
        # Each slice's cohort is a smaller stack than the one process's, and
        # the stacked torch operations around the kernels (the secular
        # solve's sums) may round otherwise at another stack size: held to
        # the f32 service bar relative to the answers' size, bitwise
        # reported.
        per = TENANTS // P
        ref = single[j]["answers"]
        errs = [float((o[j]["answers"] - ref[:, r * per:(r + 1) * per])
                      .abs().max()) for r, o in enumerate(outs_by_rank)]
        out["decoupled"]["answers_max_abs_err_vs_p1"] = max(errs)
        out["decoupled"]["answers_max_abs"] = float(ref.abs().max())
        out["decoupled"]["answers_bitwise_vs_p1"] = all(
            torch.equal(o[j]["answers"], ref[:, r * per:(r + 1) * per])
            for r, o in enumerate(outs_by_rank))
    ok = (all(out[k]["top8_eig_rel_err"] <= bar_rel
              and out[k]["top8_subspace_min_cos"] >= bar_cos
              for k in ("updates", "pairs", "window_f32"))
          and rows_ok
          and out["window_f64_guarded"]["L_err_over_lmax"] <= 1e-10
          and out["window_f64_guarded"]["U_err"] <= 1e-8
          and out["window_f64_guarded"]["clock_advance"] == accepted
          and out["window_f64_guarded"]["ages_equal"]
          and out["poisoned_block_bitwise"]
          and dec["generations"] == 10 and dec["finite"]
          and (single is None
               or out["decoupled"]["answers_max_abs_err_vs_p1"]
               <= BARS["float32"][0] * out["decoupled"]["answers_max_abs"]))
    return out, ok


def _shard_reckoning() -> dict:
    """Each rank's kernel launches per job of ``sharded_jobs``."""
    steps, guarded = SHARD_STEPS, SHARD_GUARDED
    return [
        # An update: one projection of the row block, one rotation.
        {"eigvec_project": SHARD_UPDATES, "eigvec_rotate": SHARD_UPDATES},
        # A fused pair: the two-column projection and the balancing one;
        # one rotate2 (two rotations where the merge fired).
        {"eigvec_project": 2 * SHARD_UPDATES, "pairs": SHARD_UPDATES},
        # A window step (sequential): the evict's two projections and two
        # rotations, the ingest's k-row pass, projection, two rotations.
        {"krow_project": steps, "eigvec_project": 3 * steps,
         "eigvec_rotate": 4 * steps},
        # A window step (fused pairs): the evict's two projections and pair,
        # the ingest's k-row pass, balancing projection and pair.
        {"krow_project": guarded, "eigvec_project": 3 * guarded,
         "pairs": 2 * guarded},
        {"krow_project": 3, "eigvec_project": 9, "pairs": 6},
    ]


def _launches_ok(got: dict, want: dict) -> bool:
    got = dict(got)
    if "pairs" in want:
        rot = got.get("eigvec_rotate", 0)
        got["pairs"] = got.pop("eigvec_rotate2", 0) + rot / 2
        got.pop("eigvec_rotate", None)
    return got == want


def sharded_phase(torch, cuda, state0, workdir) -> dict:
    """The row-sharded builders at P = 1 over NCCL in this process: 100
    sharded updates (f32 ``pallas``) and 100 sharded pairs (``pallas2``)
    from the multi-tenant phase's state (m = 604, capacity 1024); an f32
    ``pallas`` window block (capacity 1024, W = 1000, 100 steady steps,
    the fused k-row ingest); an f64 ``pallas2`` guarded window block
    (capacity 256, W = 200, 50 steps, every 10th point poisoned) and a
    block of poison; ``serve --decouple --mesh 1x1`` (8 tenants, capacity
    256, 40 points).  Held to ``sharded_checks``; launches to the
    reckoning."""
    import torch.distributed as tdist

    from repro_torch.core import distributed as dist
    from repro_torch.testing import spmd

    jobs, aux = sharded_jobs(torch, state0, p_tenant=1)
    t0 = time.perf_counter()
    dist.init_world(rank=0, world_size=1, backend="nccl",
                    store=tdist.FileStore(str(workdir / "store1"), 1),
                    timeout=300)
    try:
        outs = spmd.run_jobs(jobs, device="cuda", timeout=300)
    finally:       # a live NCCL group would hold the process at its exit
        tdist.destroy_process_group()
    seconds = time.perf_counter() - t0
    checks, ok = sharded_checks(torch, state0, jobs, aux, [outs])
    reckon = _shard_reckoning()
    launches_ok = all(_launches_ok(o["launches"], want)
                      for o, want in zip(outs, reckon))
    row = {"phase": "sharded", "ranks": 1, "backend": "nccl",
           "staging": outs[0]["staging"], "seconds": seconds,
           "job_seconds": [o["seconds"] for o in outs],
           "launches": [o["launches"] for o in outs[:5]],
           "collectives": [o["collectives"] for o in outs],
           "row_offsets": [o.get("row_offsets") for o in outs],
           "launches_match_reckoning": launches_ok, **checks}
    emit(row)
    if not (ok and launches_ok):
        raise AssertionError(f"sharded: {row}")
    return {"outs": outs, "jobs": jobs, "aux": aux}


def sharded_p2_phase(torch, cuda, state0, single: dict, workdir) -> dict:
    """The same work as two ranks on the one card (gloo: NCCL refuses two
    ranks on one GPU, and gloo stages CUDA tensors through host memory);
    ``--decouple --mesh 2x1`` in place of 1x1.  The kernels were built by
    this process; the ranks load them.  Rank 1's kernels run at row offset
    512 (capacity 1024) and 128 (capacity 256); each rank's launches equal
    the reckoning; the answers of each tenant slice against the P = 1
    run's for its tenants."""
    from repro_torch.testing import spmd

    jobs, aux = sharded_jobs(torch, state0, p_tenant=2)
    t0 = time.perf_counter()
    ranks = spmd.launch(2, jobs, workdir=workdir, backend="gloo",
                        device="cuda", timeout=600)
    seconds = time.perf_counter() - t0
    outs = [r["outs"] for r in ranks]
    checks, ok = sharded_checks(torch, state0, jobs, aux, outs,
                                single=single["outs"])
    reckon = _shard_reckoning()
    launches_ok = all(_launches_ok(o[j]["launches"], want)
                      for o in outs for j, want in enumerate(reckon))
    offsets = [[o[j].get("row_offsets") for j in range(5)] for o in outs]
    offsets_ok = offsets[1][:3] == [[512]] * 3 and offsets[1][3] == [128]
    row = {"phase": "sharded_p2", "ranks": 2, "backend": "gloo",
           "staging": outs[0][0]["staging"], "seconds": seconds,
           "job_seconds": [[o[j]["seconds"] for j in range(len(jobs))]
                           for o in outs],
           "launches_per_rank": [[o[j]["launches"] for j in range(5)]
                                 for o in outs],
           "collectives": [o[0]["collectives"] for o in outs],
           "row_offsets": offsets, "reference_loaded":
               [r["reference_loaded"] for r in ranks],
           "launches_match_reckoning": launches_ok, **checks}
    emit(row)
    if not (ok and launches_ok and offsets_ok
            and not any(r["reference_loaded"] for r in ranks)):
        raise AssertionError(f"sharded_p2: {row}")
    return row


def roofline_phase(torch, cuda) -> dict:
    """``launch/roofline.main`` at the reference driver's shapes, nothing
    written; the kernels' launches are counted around it and held to
    ``roofline.launch_reckoning`` (one launch a call: C = 64 is one
    ``transform_project`` launch)."""
    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    cuda.reset_launches()
    res = roofline.main(out=None)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    expect = roofline.launch_reckoning(res, launches)
    if launches != expect:
        raise AssertionError(f"roofline launch counts {launches} != "
                             f"{expect}")
    for r in res["kernels"]:
        emit({"phase": "roofline", **r})
    row = {"phase": "roofline", "device": res["device"],
           "peak_gbps": res["peak_gbps"], "triad_bytes": res["triad_bytes"],
           "fused": res["fused"], "launches": launches,
           "total_s": time.perf_counter() - t0}
    emit(row)
    return row


def _lm_params(torch, cfg):
    """The model drawn from seed 0 on the card: (model, weight bytes,
    seconds to draw them)."""
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    return params, weights, time.perf_counter() - t0


def _prefill_timing(torch, cuda, cfg, params, warmup: int,
                    timed: int) -> tuple[dict, object, Callable]:
    """``make_prefill_step`` at B = 1, T = ``LM_T``: ``warmup`` + ``timed``
    calls (host clock around synchronised calls), the kernels' launches
    held to the reckoning (one ``flash_attention`` an attention layer, one
    ``ssd_intra_chunk`` a Mamba layer), finite logits of the right shape,
    peak memory.  Returns (row entries, the tokens, the prefill step)."""
    import numpy as np

    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import steps

    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    per_forward = {"flash_attention": kinds.count("attn"),
                   "ssd_intra_chunk": kinds.count("mamba")}
    prefill = steps.make_prefill_step(cfg)
    tokens = TokenStream(vocab=cfg.vocab, seq_len=LM_T, global_batch=1,
                         seed=0).batch_at(0, "cuda")["tokens"]
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    calls = warmup + timed
    times = []
    cuda.reset_launches()
    for i in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda.LAUNCHES)
    expect = {name: calls * per_forward.get(name, 0) for name in launches}
    if launches != expect:
        raise AssertionError(f"{cfg.name} prefill launches {launches} != "
                             f"{expect} ({calls} forwards of "
                             f"{per_forward})")
    if (tuple(logits.shape) != (1, LM_T, cfg.vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill logits "
                             f"{tuple(logits.shape)} or not finite")
    del logits
    p50 = float(np.percentile(times, 50))
    return ({"prefill_B": 1, "prefill_T": LM_T, "prefill_calls": calls,
             "prefill_ms_p50": p50,
             "prefill_ms_p99": float(np.percentile(times, 99)),
             "prefill_ms": times, "prefill_tokens_per_s": LM_T / p50 * 1e3,
             "max_memory_allocated_gib":
                 torch.cuda.max_memory_allocated() / 2 ** 30,
             "resident_before_gib": resident / 2 ** 30,
             "launches": launches, "launches_per_forward": per_forward},
            tokens, prefill)


def _decode_logits(torch, cuda, cfg, params, prompt):
    """Float32 logits of ``decode_step`` teacher-forced over ``prompt``
    (1, T) from caches built at T positions, and its kernel launches."""
    from repro_torch.models import lm

    T = prompt.shape[1]
    cuda.reset_launches()
    caches = lm.init_caches(params, cfg, 1, T)
    dec = []
    for t in range(T):
        lg, caches = lm.decode_step(params, cfg, caches, prompt[:, t:t + 1],
                                    torch.full((1, 1), t,
                                               device=prompt.device))
        dec.append(lg.float())
    torch.cuda.synchronize()
    return torch.cat(dec, dim=1), sum(cuda.LAUNCHES.values())


def _prefill_and_decode(torch, cuda, cfg, params, prompt):
    """Float32 logits of the forward over ``prompt`` and of the
    teacher-forced decode (``_decode_logits``), and the decode's kernel
    launches."""
    from repro_torch.models import lm

    full = lm.forward(params, cfg, prompt).float()
    return (full, *_decode_logits(torch, cuda, cfg, params, prompt))


def _logit_check(torch, full, dec, launches: int, bar: float,
                 held=None, gate: bool = True) -> dict:
    """Prefill against decode logits, each position's largest difference
    over the prefill's largest |logit|; the worst over the positions
    ``held`` (a (T,) bool mask; all by default) must be within ``bar``
    (where ``gate``), as must the last position where it is held; finite
    logits and no kernel launch in decode."""
    scale = float(full.abs().max())
    diff = (full - dec).abs()
    per_pos = diff.amax(-1)[0] / scale                      # (T,)
    if held is None:
        held = torch.ones_like(per_pos, dtype=torch.bool)
    worst = float(per_pos[held].max()) if bool(held.any()) else 0.0
    res = {"prompt": full.shape[1], "max_abs_logit": scale,
           "last_position_rel": float(per_pos[-1]),
           "last_position_held": bool(held[-1]),
           "worst_position_rel": worst,
           "mean_rel": float(diff.mean()) / scale,
           "argmax_agreement": float((full.argmax(-1) == dec.argmax(-1))
                                     .float().mean()),
           "finite": bool(torch.isfinite(full).all()
                          and torch.isfinite(dec).all()),
           "bar": bar, "held_to_bar": gate, "kernel_launches": launches}
    if not (res["finite"] and launches == 0 and (worst <= bar or not gate)):
        raise AssertionError(f"prefill vs decode: {res}")
    return res


def _serve_check(torch, cuda, cfg, params) -> dict:
    """``serve --mode lm`` as ``lm_main`` runs it (batch 4, prompt 16, gen
    32): finite logits, tokens in the vocabulary, no kernel launch."""
    from repro_torch.launch import serve

    cuda.reset_launches()
    served = serve.lm_main(cfg, batch=4, prompt_len=16, gen=32, seed=0,
                           device="cuda", params=params)
    launches = sum(cuda.LAUNCHES.values())
    if not (served["finite"] and served["tokens_in_vocab"]
            and launches == 0):
        raise AssertionError(f"{cfg.name} serve: {served}, {launches} "
                             f"kernel launches")
    return {**served, "kernel_launches": launches}


def lm_phase(torch, cuda) -> tuple[dict, Callable[[], object]]:
    """The LM serving path at Jamba-1.5-Large's full width (one period,
    without its experts, bf16): the prefill step timed with its launches
    reckoned, the prefill held against teacher-forced decode, and ``serve
    --mode lm``.  Returns the row and one prefill call on the same
    parameters, for ``lm_profile_phase``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import param_count

    cfg = dataclasses.replace(get_config("jamba_1_5_large_398b"),
                              n_layers=8, moe=None)
    t_phase = time.perf_counter()
    params, weights, init_s = _lm_params(torch, cfg)
    timing, tokens, prefill = _prefill_timing(torch, cuda, cfg, params,
                                              LM_WARMUP, LM_TIMED)
    check = _logit_check(torch, *_prefill_and_decode(
        torch, cuda, cfg, params, tokens[:, :LM_DECODE_T]), LM_BAR)
    row = {"phase": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
           "moe": None, "dtype": cfg.dtype, "params": param_count(cfg),
           "weights_gib": weights / 2 ** 30, "init_s": init_s, **timing,
           "decode_check": check,
           "serve": _serve_check(torch, cuda, cfg, params),
           "total_s": time.perf_counter() - t_phase}
    emit(row)
    return row, lambda: prefill(params, {"tokens": tokens})


@contextlib.contextmanager
def recorded_routes(moe_mod):
    """While open, every MoE layer call records its expert ids and slot
    positions, each (tokens, K), in call order: the module's router and
    position functions are wrapped for the duration (the main path has no
    switch for it), and restored on leaving."""
    log = {"idx": [], "pos": []}
    router, positions = moe_mod._router, moe_mod._causal_positions

    def recording_router(p, cfg, x2d):
        out = router(p, cfg, x2d)
        log["idx"].append(out[1])
        return out

    def recording_positions(onehot, counts0=None):
        out = positions(onehot, counts0)
        log["pos"].append(out[0].reshape(-1, onehot.shape[2]))
        return out

    moe_mod._router = recording_router
    moe_mod._causal_positions = recording_positions
    try:
        yield log
    finally:
        moe_mod._router, moe_mod._causal_positions = router, positions


def _route_stats(torch, cfg, log, T: int) -> dict:
    """A recorded T-token prefill's routing over its MoE layers: tokens per
    expert (assignments, dropped ones included) and the dropped share."""
    from repro_torch.models import moe

    idx = torch.stack(log["idx"])                          # (L, T, K)
    pos = torch.stack(log["pos"])
    C = moe._capacity(cfg, T)
    per_expert = torch.stack([torch.bincount(i.reshape(-1),
                                             minlength=cfg.moe.n_experts)
                              for i in idx])               # (L, E)
    return {"T": T, "capacity": C, "moe_layers": idx.shape[0],
            "assignments": idx.numel(),
            "dropped_share": float((pos >= C).float().mean()),
            "tokens_per_expert_min": int(per_expert.min()),
            "tokens_per_expert_max": int(per_expert.max()),
            "tokens_per_expert_by_layer": per_expert.tolist()}


def _route_agreement(torch, cfg, prefill_log, decode_log, T: int):
    """Prefill's routes against teacher-forced decode's over T tokens.  A
    (token, layer, k) choice agrees where decode chose the same expert for
    that token and layer; a position's route agrees in a layer where it
    chose the same experts there and kept or dropped each alike.  A
    position whose route differs in layer l carries another hidden state
    into every later layer, so its later choices follow from that first
    difference: ``choice_agreement_to_first_flip`` counts each position's
    choices up to and including the first layer where its route differs,
    and must reach ``ROUTE_AGREEMENT``; ``choice_agreement`` counts all of
    them.  Returns (the report, the (T,) mask of positions whose routes
    agree in every layer)."""
    from repro_torch.models import moe

    C = moe._capacity(cfg, T)
    pre_idx = torch.stack(prefill_log["idx"])              # (L, T, K)
    L, K = pre_idx.shape[0], pre_idx.shape[2]
    # decode: one call a layer a step, step-major
    dec_idx = torch.stack(decode_log["idx"]).reshape(T, L, K).transpose(0, 1)
    dec_pos = torch.stack(decode_log["pos"]).reshape(T, L, K).transpose(0, 1)
    pre_keep = torch.stack(prefill_log["pos"]) < C
    choice = (pre_idx[..., :, None] == dec_idx[..., None, :]).any(-1)
    p_sorted, p_order = pre_idx.sort(-1)
    d_sorted, d_order = dec_idx.sort(-1)
    same_experts = (p_sorted == d_sorted).all(-1)          # (L, T)
    same_keep = (pre_keep.gather(-1, p_order)
                 == (dec_pos < C).gather(-1, d_order)).all(-1)
    same = same_experts & same_keep
    # layers whose every earlier layer routed the position alike
    before_flip = torch.cat([torch.ones_like(same[:1]), same[:-1]]
                            ).long().cumprod(0).bool()
    to_flip = choice[before_flip]
    report = {"choices": choice.numel(),
              "choice_agreement": float(choice.float().mean()),
              "choice_agreement_by_layer":
                  choice.float().mean((1, 2)).tolist(),
              "choices_to_first_flip": to_flip.numel(),
              "choice_agreement_to_first_flip":
                  float(to_flip.float().mean()),
              "positions_agreeing": int(same.all(0).sum()),
              "positions_other_experts": int((~same_experts.all(0)).sum()),
              "positions_other_drops": int((same_experts.all(0)
                                            & ~same_keep.all(0)).sum()),
              "first_flip_by_layer": [int(v) for v in (
                  before_flip & ~same).sum(1)],
              "bar_choice_agreement_to_first_flip": ROUTE_AGREEMENT}
    return report, same.all(0)


def lm_moe_phase(torch, cuda) -> dict:
    """DBRX-132B's serving path at its full widths (d_model 6144, 48 q / 8
    kv heads of 128, 16 experts top-4 of width 10752, vocab 100352; bf16),
    cut to ``LM_MOE_LAYERS`` of its 40 layers, weights drawn on the card:
    the prefill timed with one ``flash_attention`` a layer, the routing of
    one 4096-token prefill (dropped share, tokens per expert), prefill
    against teacher-forced decode over ``LM_DECODE_T`` tokens with caches
    built there (so decode's capacity is the prefill's), the routes of
    both recorded: at least ``ROUTE_AGREEMENT`` of the (token, layer, k)
    choices agree up to each position's first differing layer
    (``_route_agreement``), and the positions whose routes agree in every
    layer hold ``LM_MOE_BAR``; then ``serve --mode lm``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    from repro_torch.models.config import param_count

    full_cfg = get_config("dbrx_132b")
    cfg = dataclasses.replace(full_cfg, n_layers=LM_MOE_LAYERS)
    t_phase = time.perf_counter()
    params, weights, init_s = _lm_params(torch, cfg)
    timing, tokens, prefill = _prefill_timing(torch, cuda, cfg, params,
                                              LM_WARMUP, LM_TIMED)
    with recorded_routes(moe) as log:
        prefill(params, {"tokens": tokens})
    routing = _route_stats(torch, cfg, log, LM_T)
    del log
    prompt = tokens[:, :LM_DECODE_T]
    with recorded_routes(moe) as log_p:
        full = lm.forward(params, cfg, prompt).float()
    with recorded_routes(moe) as log_d:
        dec, launches = _decode_logits(torch, cuda, cfg, params, prompt)
    routes, agree = _route_agreement(torch, cfg, log_p, log_d, LM_DECODE_T)
    if routes["choice_agreement_to_first_flip"] < ROUTE_AGREEMENT:
        raise AssertionError(f"{cfg.name} routes: {routes}")
    check = _logit_check(torch, full, dec, launches, LM_MOE_BAR, agree)
    del full, dec, log_p, log_d
    served = _serve_check(torch, cuda, cfg, params)
    row = {"phase": "lm_moe", "arch": cfg.name, "n_layers": cfg.n_layers,
           "reduced": {"n_layers": [cfg.n_layers, full_cfg.n_layers]},
           "widths": {k: getattr(cfg, k) for k in (
               "d_model", "n_heads", "n_kv_heads", "head_dim", "vocab")},
           "moe": dataclasses.asdict(cfg.moe), "dtype": cfg.dtype,
           "params": param_count(cfg), "weights_gib": weights / 2 ** 30,
           "init_s": init_s, **timing, "routing_prefill": routing,
           "decode_routes": routes, "decode_check": check,
           "serve": served, "total_s": time.perf_counter() - t_phase}
    emit(row)
    del params
    torch.cuda.empty_cache()
    return row


def _xlstm_block_check(torch, cfg, params) -> dict:
    """Each xLSTM block kind at the model's width, the first layer of the
    kind: its parallel form against its recurrence, step by step from a
    fresh cache, over ``LM_DECODE_T`` tokens of seeded N(0, 1) inputs in
    the model's type; each position's relative error (L2 over the width)
    within ``LM_XLSTM_BLOCK_BAR``."""
    from repro_torch.models import xlstm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn((1, LM_DECODE_T, cfg.d_model), generator=gen,
                    device="cuda").to(getattr(torch, cfg.dtype))
    out = {}
    for kind in ("mlstm", "slstm"):
        i = next(i for i in range(cfg.n_layers) if cfg.block_kind(i) == kind)
        mixer = params.layers[i].mixer
        y = getattr(xlstm, f"{kind}_apply")(mixer, cfg, x).float()
        cache = getattr(xlstm, f"{kind}_cache_init")(cfg, 1, "cuda")
        ys = []
        for t in range(LM_DECODE_T):
            yt, cache = getattr(xlstm, f"{kind}_decode")(
                mixer, cfg, x[:, t:t + 1], cache)
            ys.append(yt.float())
        rel = ((y - torch.cat(ys, 1)).norm(dim=-1) / y.norm(dim=-1))[0]
        out[kind] = {"layer": i, "worst_position_rel": float(rel.max()),
                     "median_position_rel": float(rel.median())}
    out["bar"] = LM_XLSTM_BLOCK_BAR
    if not all(out[k]["worst_position_rel"] <= LM_XLSTM_BLOCK_BAR
               for k in ("mlstm", "slstm")):
        raise AssertionError(f"{cfg.name} blocks, parallel vs recurrent: "
                             f"{out}")
    return out


def lm_xlstm_phase(torch, cuda) -> dict:
    """xLSTM-125m whole (12 layers: 10 mLSTM, 2 sLSTM; d 768, 4 heads,
    vocab 50304; bf16): the prefill timed (``LM_XLSTM_CALLS``: the two
    sLSTM layers step through 4096 tokens one at a time), prefill against
    teacher-forced decode over ``LM_DECODE_T`` tokens (reported beside
    ``LM_XLSTM_BAR``; each block kind held to ``LM_XLSTM_BLOCK_BAR``), and
    ``serve --mode lm``.  No kernel is on this path: every launch count
    must stay 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import param_count

    cfg = get_config("xlstm_125m")
    t_phase = time.perf_counter()
    params, weights, init_s = _lm_params(torch, cfg)
    timing, tokens, _ = _prefill_timing(torch, cuda, cfg, params,
                                        *LM_XLSTM_CALLS)
    check = _logit_check(torch, *_prefill_and_decode(
        torch, cuda, cfg, params, tokens[:, :LM_DECODE_T]), LM_XLSTM_BAR,
        gate=False)
    row = {"phase": "lm_xlstm", "arch": cfg.name, "n_layers": cfg.n_layers,
           "reduced": None, "dtype": cfg.dtype, "params": param_count(cfg),
           "weights_gib": weights / 2 ** 30, "init_s": init_s, **timing,
           "kernels": "none: mLSTM and sLSTM run in plain PyTorch (the "
                      "reference's reach no kernel)",
           "decode_check": check,
           "blocks_check": _xlstm_block_check(torch, cfg, params),
           "serve": _serve_check(torch, cuda, cfg, params),
           "total_s": time.perf_counter() - t_phase}
    emit(row)
    del params
    torch.cuda.empty_cache()
    return row


# MiniCPM-2B trained whole (lm_train): B sequences of T tokens, STEPS
# optimizer steps (AdamW, the WSD schedule over STEPS steps, remat per
# layer).
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 2048, 4
# Jamba-1.5-Large trained at full width (lm_train_jamba): the first four
# layers of its period, in order, without experts; B sequences of T tokens
# (16 chunks of 256), STEPS AdamW steps.  Its whole 8-layer period needs
# ~107 GB with AdamW's f32 moments, more than the card holds.
JAMBA_TRAIN_PATTERN = ("mamba", "mamba", "mamba", "attn")
TRAIN_JAMBA_B, TRAIN_JAMBA_T, TRAIN_JAMBA_STEPS = 1, 4096, 4
# The smoke step on the card against the CPU (lm_train_check): the loss
# within 1e-5 and each gradient leaf within 1e-4 of its largest magnitude,
# the reference's bar between its naive and flash attention carried
# through the backward (float32 both sides; the card's attention is the
# SIMT kernel and its backward, the CPU's the plain versions).
TRAIN_CHECK_LOSS, TRAIN_CHECK_GRAD = 1e-5, 1e-4
# Nyström attention at MiniCPM's widths (lm_nystrom), 2 layers, f32, one
# chunk of T = 256 tokens with each layer's landmarks set to its 256 keys:
# the prefill is exact attention in the chunk; decode reads every key
# through the landmarks, g(q, L) G⁻¹ g(L, k) = g(q, k) for k in L up to
# the jitter 1e-4 on a gram near the identity (~1e-4 relative).  On a CPU
# in f32 the gap read 1.3e-5 of the largest logit.  Bar 1e-3.
NYSTROM_T, NYSTROM_BAR = 256, 1e-3
# grow_landmark on the card: 64 landmarks added by Algorithm 1 (f64, the
# rotation kernel's route) to 8 seed landmarks of hd 64 (spread 0.3, so
# the RBF gram at σ = 16 has a spread spectrum); the eigenvalues within
# 1e-9 of λmax of f64 eigh of the grown gram (the reference test's 1e-8
# for 1 update, carried over 64 updates of ~1e-14 each).
GROW_SEED, GROW_STEPS, GROW_BAR = 8, 64, 1e-9


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def step_launches(cfg) -> dict:
    """The LM kernels' launches of one loss-and-gradient pass with remat:
    per attention layer ``flash_attention`` twice (forward and remat's
    recompute) and its backward once, per Mamba layer ``ssd_intra_chunk``
    twice and its backward once; kernels with no launch left out."""
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    attn, mamba = kinds.count("attn"), kinds.count("mamba")
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "ssd_intra_chunk": 2 * mamba, "ssd_intra_chunk_bwd": mamba}
    return {k: v for k, v in want.items() if v}


def train_reckoning(cfg, B: int, T: int) -> dict:
    """What a train step holds on the card, reckoned before it runs:
    parameters and gradients in the model's type, two float32 moments,
    the inputs remat keeps (one (B, T, d) activation a layer), the logits
    in the model's type, their float32 copy and its gradient; and the LM
    kernels' launches a step (``step_launches``)."""
    from repro_torch.models.config import param_count

    n = param_count(cfg)
    item = 2 if cfg.dtype == "bfloat16" else 4
    logits = B * T * cfg.vocab
    parts = {"params_and_grads_gb": 2 * n * item / 1e9,
             "moments_gb": 2 * n * 4 / 1e9,
             "remat_inputs_gb": cfg.n_layers * B * T * cfg.d_model * item
             / 1e9,
             "logits_gb": logits * (item + 4 + 4) / 1e9}
    return {"params": n, **parts, "total_gb": sum(parts.values()),
            "launches_per_step": step_launches(cfg)}


def _model_flops(cfg, n: int, B: int, T: int) -> float:
    """Model FLOPs of one train step: 6·N·tokens for the weights, and the
    causal attention's QKᵀ and PV (4·hd flops per pair s <= t a head)
    three times (forward, and twice that in the backward); remat's
    recompute is not counted, nor the Mamba layers' own intra-chunk and
    chunk-state products (SSD's flops beyond its weights)."""
    attn = sum(4.0 * cfg.hd * cfg.n_heads * B * T * (T + 1) / 2
               for i in range(cfg.n_layers) if cfg.block_kind(i) == "attn")
    return 6.0 * n * B * T + 3 * attn


def _train_phase(torch, cuda, phase: str, arch: str, cfg, B: int, T: int,
                 n_steps: int, reduced) -> dict:
    """``n_steps`` steps of ``make_train_step`` for ``cfg`` (``arch``'s
    optimizer and schedule, as ``launch/train`` picks them: AdamW with
    float32 moments here; clipping to norm 1; remat per period) on
    ``TokenStream`` batches of B x T, the parameters drawn from seed 0 on
    the card.  The memory reckoning is printed before the run, the peak
    beside it after; each step's loss, gradient norm and rate, finite; the
    LM kernels' launches a step against the reckoning; step ms, tokens/s,
    the model-FLOP share of the bf16 dense peak.  Then the same two first
    steps from seed 0 again: their gradient norms and the parameters after
    them bit for bit."""
    import numpy as np

    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import steps

    reck = train_reckoning(cfg, B, T)
    emit({"phase": phase, "reckoning": reck, "card": _smi()})
    t_phase = time.perf_counter()
    optimizer = steps.optimizer_for(arch)
    schedule = steps.schedule_for(arch, total=n_steps)
    stream = TokenStream(vocab=cfg.vocab, seq_len=T, global_batch=B, seed=0)
    batches = [stream.batch_at(i, "cuda") for i in range(n_steps)]

    def run(count: int, record: bool, against: dict | None = None):
        """``count`` steps from seed 0.  With ``record`` the parameters
        before and after, on the host (the card holds the state only),
        and how many moved; with ``against`` whether the parameters after
        equal those, bit for bit."""
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state = steps.init_train_state(cfg, optimizer, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        train_step = steps.make_train_step(cfg, optimizer, schedule)
        init = ({k: p.detach().to("cpu", copy=True) for k, p in
                 state.params.named_parameters()} if record else None)
        torch.cuda.reset_peak_memory_stats()
        out = []
        for i in range(count):
            cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(state, batches[i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out.append({"step": i, "ms": ms, "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "grad_norm_bits": m["grad_norm"].cpu().view(
                            torch.int32).item(),
                        "lr": m["lr"], "accuracy": float(m["accuracy"]),
                        "launches": {k: v for k, v in cuda.LAUNCHES.items()
                                     if v}})
        peak = torch.cuda.max_memory_allocated()
        params = None
        if record:
            params = {k: p.detach().cpu() for k, p in
                      state.params.named_parameters()}
            out[-1]["params_moved"] = sum(
                int(not torch.equal(init[k], p)) for k, p in params.items())
            out[-1]["params"] = len(init)
        if against is not None:
            out[-1]["params_bitwise"] = all(
                torch.equal(against[k], p.detach().cpu())
                for k, p in state.params.named_parameters())
        del state, init
        return out, peak, init_s, params

    steps_out, peak, init_s, _ = run(n_steps, record=False)
    want = reck["launches_per_step"]
    for r in steps_out:
        if r["launches"] != want:
            raise AssertionError(f"{phase} step {r['step']} launches "
                                 f"{r['launches']} != {want}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"{phase} step {r['step']}: {r}")
    times = [r["ms"] for r in steps_out]
    p50 = float(np.percentile(times, 50))
    tokens = B * T
    flops = _model_flops(cfg, reck["params"], B, T)
    # Determinism: two steps from seed 0 twice, bit for bit.
    det = {}
    first, _, _, p_first = run(2, record=True)
    again, _, _, _ = run(2, record=False, against=p_first)
    del p_first
    det["grad_norms_bitwise"] = [a["grad_norm_bits"] == b["grad_norm_bits"]
                                 for a, b in zip(first, again)]
    det["grad_norms_equal_the_run"] = [
        a["grad_norm_bits"] == b["grad_norm_bits"]
        for a, b in zip(first, steps_out)]
    det["params_bitwise"] = again[-1]["params_bitwise"]
    det["params_moved_of"] = (first[-1]["params_moved"],
                              first[-1]["params"])
    torch.cuda.empty_cache()
    if not (all(det["grad_norms_bitwise"]) and det["params_bitwise"]
            and det["params_moved_of"][0] > 0):
        raise AssertionError(f"{phase}: two runs from seed 0 differ: {det}")
    row = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "block_pattern": list(cfg.block_pattern),
           "moe": cfg.moe is not None,
           "reduced": reduced, "dtype": cfg.dtype, "B": B, "T": T,
           "optimizer": optimizer.name,
           "schedule": "wsd" if "minicpm" in arch else "cosine",
           "remat": "per period" if cfg.period > 1 else "per layer",
           "init_s": init_s, "steps": steps_out,
           "step_ms_p50": p50, "step_ms": times,
           "tokens_per_s": tokens / p50 * 1e3,
           "model_flops_per_step": flops,
           "model_flops_exclude": "SSD's intra-chunk and chunk-state "
                                  "products (beyond 6·N·tokens)",
           "model_flop_share_of_bf16_peak": flops / (p50 / 1e3) / 989e12,
           "peak_memory_gb": peak / 1e9, "peak_memory_gib": peak / 2 ** 30,
           "reckoned_memory_gb": reck["total_gb"],
           "launches_per_step": want, "determinism": det, "card": _smi(),
           "total_s": time.perf_counter() - t_phase}
    emit(row)
    return {**row, "launches": {k: sum(r["launches"][k] for r in steps_out)
                                for k in want}}


def lm_train_phase(torch, cuda) -> dict:
    """MiniCPM-2B trained whole on the card (40 layers, d_model 2304, 36
    heads of 64, d_ff 5760, vocab 122753, tied embeddings, residual scale
    1.4/√40; bf16 parameters drawn from seed 0 on the card): ``TRAIN_STEPS``
    steps of ``make_train_step`` (AdamW with float32 moments, the WSD
    schedule, clipping to norm 1, remat per layer) on ``TokenStream``
    batches of B = 4, T = 2048 (``_train_phase``): 80 ``flash_attention``
    and 40 backward launches a step."""
    from repro_torch.configs import get_config

    return _train_phase(torch, cuda, "lm_train", "minicpm_2b",
                        get_config("minicpm_2b"), TRAIN_B, TRAIN_T,
                        TRAIN_STEPS, None)


def lm_train_jamba_phase(torch, cuda) -> dict:
    """Jamba-1.5-Large trained on the card at every published width
    (d_model 8192, 64 q / 8 kv heads of 128, d_ff 24576, vocab 65536,
    Mamba N = 128, 256 heads of 64, chunk 256): the first four layers of
    its period in order (``JAMBA_TRAIN_PATTERN``, one period, remat around
    it) with ``moe=None``, as the ``lm`` phase runs it: 4.87 B bf16
    parameters drawn from seed 0 on the card; ``TRAIN_JAMBA_STEPS`` steps
    of AdamW (float32 moments), the cosine schedule over the steps,
    clipping, on B = 1, T = 4096 (16 chunks) (``_train_phase``): a step
    launches ``ssd_intra_chunk`` 6 times (3 Mamba layers, forward and
    recompute), its backward 3, ``flash_attention`` 2 and its backward
    1."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = "jamba_1_5_large_398b"
    cfg = dataclasses.replace(get_config(arch), moe=None,
                              block_pattern=JAMBA_TRAIN_PATTERN,
                              n_layers=len(JAMBA_TRAIN_PATTERN))
    return _train_phase(torch, cuda, "lm_train_jamba", arch, cfg,
                        TRAIN_JAMBA_B, TRAIN_JAMBA_T, TRAIN_JAMBA_STEPS,
                        {"n_layers": [72, cfg.n_layers], "moe": "none",
                         "why": "AdamW's f32 moments: one 8-layer period "
                                "needs ~107 GB, more than the card's 80"})


def _train_check(torch, cuda, phase: str, cfg, tokens) -> dict:
    """One train step of a smoke config (float32) on the card against the
    same step on the CPU from the same weights and batch: where the model
    has experts, first the routes (every MoE layer call's top-k expert ids
    on both devices, forward and remat's recompute, equal); then the loss
    (``TRAIN_CHECK_LOSS``), every gradient leaf (``TRAIN_CHECK_GRAD`` of
    its largest magnitude), the LM kernels' launches (``step_launches``)
    and the parameters after one AdamW step at a constant rate of 1e-3.
    AdamW's first step moves an entry by lr·(g/(|g| + eps) + wd·p): with
    the gradients within δ = TRAIN_CHECK_GRAD·max|g| of each other, the
    step's u differs by at most min(2, 2δ/(|g| + eps)), so each entry is
    held to lr times that plus four float32 roundings of |p|."""
    from repro_torch.launch import steps
    from repro_torch.models import lm, moe
    from repro_torch.optim import optimizers, schedules

    t0 = time.perf_counter()
    cpu = lm.init_params(cfg, seed=0)
    gpu = lm.init_params(cfg, seed=0, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    out, routes = {}, {}
    cuda.reset_launches()
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        b = {k: v.to(dev) for k, v in batch.items()}
        with recorded_routes(moe) as log:
            loss, _ = lm.loss_fn(model, cfg, b)
            leaves = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(leaves.values()))
        routes[dev] = [i.cpu() for i in log["idx"]]
        out[dev] = (float(loss.detach()), {k: g.detach().cpu() for k, g in
                                           zip(leaves, grads)})
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    routes_alike = (len(routes["cuda"]) == len(routes["cpu"]) and all(
        torch.equal(a, b) for a, b in zip(routes["cuda"], routes["cpu"])))
    if not routes_alike:
        raise AssertionError(f"{phase}: the card's expert choices differ "
                             f"from the CPU's")
    loss_err = abs(out["cuda"][0] - out["cpu"][0])
    worst = 0.0
    for k, g in out["cpu"][1].items():
        err = float((out["cuda"][1][k] - g).abs().max())
        worst = max(worst, err / max(float(g.abs().max()), 1e-30))
    params = {}
    lr = 1e-3
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        opt = optimizers.adamw()
        state = steps.TrainState(torch.zeros((), dtype=torch.int32), model,
                                 opt.init(steps.param_dict(model)))
        step = steps.make_train_step(cfg, opt, schedules.constant(lr))
        step(state, {k: v.to(dev) for k, v in batch.items()})
        params[dev] = {k: p.detach().cpu() for k, p in
                       model.named_parameters()}
    eps32 = torch.finfo(torch.float32).eps
    p_worst = 0.0
    for k, p in params["cpu"].items():
        g = out["cpu"][1][k]
        delta = TRAIN_CHECK_GRAD * float(g.abs().max())
        bound = lr * torch.clamp(2 * delta / (g.abs() + 1e-8), max=2.0) \
            + 4 * eps32 * p.abs()
        ratio = float(((params["cuda"][k] - p).abs() / bound).max())
        p_worst = max(p_worst, ratio)
    row = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
           "block_pattern": list(cfg.block_pattern),
           "moe": cfg.moe is not None, "B": batch["tokens"].shape[0],
           "T": batch["tokens"].shape[1],
           "moe_calls_routed_alike": len(routes["cuda"]),
           "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
           "loss_err": loss_err, "loss_bar": TRAIN_CHECK_LOSS,
           "worst_grad_rel_err": worst, "grad_bar": TRAIN_CHECK_GRAD,
           "worst_param_err_over_bound": p_worst,
           "launches_loss_and_grads": launches,
           "total_s": time.perf_counter() - t0}
    emit(row)
    if not (loss_err <= TRAIN_CHECK_LOSS and worst <= TRAIN_CHECK_GRAD
            and p_worst <= 1.0):
        raise AssertionError(f"{phase}: {row}")
    if launches != step_launches(cfg):
        raise AssertionError(f"{phase} launches {launches} != "
                             f"{step_launches(cfg)}")
    return row


def lm_train_check_phase(torch, cuda) -> dict:
    """``_train_check`` for MiniCPM-2B's smoke config (2 layers, d 64) at
    B 4, T 64, and for Jamba's smoke cut as ``tests/test_torch_train.py``
    takes it (a Mamba layer, then an attention layer with the experts,
    d 64, Mamba N 8, 8 heads of 16, chunk 8) at B 2, T 64: 8 chunks, the
    backward kernel's f32 route."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config("minicpm_2b", smoke=True)
    rows = {"minicpm": _train_check(
        torch, cuda, "lm_train_check", cfg,
        torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                           (4, 65))))}
    cfg = dataclasses.replace(get_config("jamba_1_5_large_398b", smoke=True),
                              block_pattern=("mamba", "attn"), n_layers=2)
    rows["jamba"] = _train_check(
        torch, cuda, "lm_train_check_jamba", cfg,
        torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab,
                                                           (2, 65))))
    return rows


def lm_nystrom_phase(torch, cuda) -> dict:
    """Nyström attention on the card: a dense config at MiniCPM-2B's widths
    (d 2304, 36 heads of 64, d_ff 5760, vocab 122753) with
    ``attention="nystrom"``, 2 layers, float32, landmarks m = 256; each
    layer's landmarks set to its keys of a T = 256 prompt, then the
    prefill against teacher-forced decode within ``NYSTROM_BAR``.  Then
    ``grow_landmark`` ``GROW_STEPS`` times on the card (f64, the rotation
    kernel's route: two ``eigvec_rotate`` launches a landmark), its
    eigenvalues against f64 eigh of the grown gram within ``GROW_BAR`` of
    λmax."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import kernels_fn as kf
    from repro_torch.core import inkpca
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import layers, lm
    from repro_torch.models import nystrom_attention as nys

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm_2b"), n_layers=2,
                              attention="nystrom", dtype="float32")
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = TokenStream(vocab=cfg.vocab, seq_len=NYSTROM_T, global_batch=1,
                         seed=1).batch_at(0, "cuda")["tokens"]
    pos = torch.arange(NYSTROM_T, device="cuda")[None]
    with torch.inference_mode():
        h = lm.embed_tokens(params, cfg, prompt)
        for layer in params.layers:
            hn = layers.rmsnorm_apply(layer.norm1, h)
            _, k, _ = layers._qkv(layer.mixer, cfg, hn, pos)
            layer.mixer.landmarks.copy_(k[0].permute(1, 0, 2).float())
            h = lm._block(layer, cfg, h, pos)
        full, dec, launches = _prefill_and_decode(torch, cuda, cfg, params,
                                                  prompt)
    check = _logit_check(torch, full, dec, launches, NYSTROM_BAR)
    del params, full, dec
    torch.cuda.empty_cache()

    # grow_landmark on the card, f64.
    hd = cfg.hd
    sigma = 2.0 * hd ** 0.5
    M = GROW_SEED + GROW_STEPS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = 0.3 * torch.randn((M, hd), generator=gen, device="cuda",
                             dtype=torch.float64)
    spec = kf.KernelSpec(name="rbf", sigma=sigma)
    st = inkpca.init_state(rows[:GROW_SEED], M, spec, adjusted=False,
                           dtype=torch.float64)
    lms = torch.zeros_like(rows)
    lms[:GROW_SEED] = rows[:GROW_SEED]
    state = (lms, st.L, st.U, st.m)
    cuda.reset_launches()
    for i in range(GROW_SEED, M):
        state = nys.grow_landmark(*state, rows[i], sigma)
    torch.cuda.synchronize()
    grow_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    lms, L, U, m = state
    G = kf.gram_block(rows, rows, spec=spec)
    lam = torch.linalg.eigvalsh(G)
    lam_inc = torch.sort(L[:M]).values
    grow_err = float((lam_inc - lam).abs().max() / lam.abs().max())
    ginv = nys.ginv_from_eig(L, U, m, jitter=0.0)
    ginv_err = float((ginv @ G - torch.eye(M, dtype=G.dtype,
                                          device="cuda")).abs().max())
    row = {"phase": "lm_nystrom", "widths": {k: getattr(cfg, k) for k in (
        "d_model", "n_heads", "n_kv_heads", "hd", "d_ff", "vocab",
        "nystrom_landmarks")}, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "decode_check": check,
           "grow": {"seed_landmarks": GROW_SEED, "grown": GROW_STEPS,
                    "m": int(m), "dtype": "float64",
                    "eig_rel_err": grow_err, "bar": GROW_BAR,
                    "ginv_times_g_minus_i": ginv_err,
                    "launches": grow_launches},
           "total_s": time.perf_counter() - t0}
    emit(row)
    want = {"eigvec_rotate": 2 * GROW_STEPS}
    if not (grow_err <= GROW_BAR and int(m) == M and grow_launches == want):
        raise AssertionError(f"lm_nystrom grow_landmark: {row['grow']}, "
                             f"launches {grow_launches} != {want}")
    return row


def lm_profile_phase(checks, prefill_call) -> dict:
    """Where one prefill's device time goes: one call under the profiler
    (device records by kernel group, the device's busy and idle share).
    It runs after the timing phase: on one H100 host the profiler recorded
    no device activity at all in the timing phase once a prefill had been
    profiled before it.  Where it records none here, the breakdown and the
    idle share are None: not measured."""
    t0 = time.perf_counter()
    records, wall = checks.device_breakdown(prefill_call)
    breakdown = {}
    for name, ms in records.items():
        group = next((g for g, keys in LM_GROUPS if any(
            k in name.lower() for k in keys)), "other")
        breakdown[group] = breakdown.get(group, 0.0) + ms
    busy = sum(records.values()) if records else None
    top = sorted(records.items(), key=lambda kv: -kv[1])[:8]
    row = {"phase": "lm_profile", "profiled_wall_ms": wall,
           "device_busy_ms": busy,
           "idle_share": None if busy is None else 1.0 - busy / wall,
           "device_ms_by_group": breakdown or None,
           "top_device_records_ms": dict(top) or None,
           "total_s": time.perf_counter() - t0}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import checks, cuda
    from repro_torch.launch import serve

    resolve_device("cuda")        # pins TF32 off for every product below
    clock = PhaseClock()
    t0 = time.perf_counter()
    info = cuda.build()
    cuda.library()
    built_s = time.perf_counter() - t0
    sass = cuda.sass_counts()
    clock.seconds["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": built_s,
          "nvcc_seconds": info["seconds"], "cached": info["cached"],
          "ptxas_registers": ptxas_summary(info.get("ptxas", {})),
          "sass_mma": sass, "total_s": clock.seconds["build"]})

    checked = clock("kernels", kernel_phase, torch, checks, cuda)
    checked_b = clock("kernels_batched", batched_kernel_phase, torch, checks)
    runs = {"pallas": clock("service f32 pallas", service_phase, torch,
                            cuda, serve, 1024, 600, "float32", "pallas"),
            "pallas2": clock("service f32 pallas2", service_phase, torch,
                             cuda, serve, 1024, 600, "float32", "pallas2")}
    clock("service f64 pallas", service_phase, torch, cuda, serve, 256, 200,
          "float64", "pallas")
    clock("service f64 pallas2", service_phase, torch, cuda, serve, 256,
          200, "float64", "pallas2")
    _, nystrom_state = clock("nystrom f32", nystrom_phase, torch, cuda,
                             serve, "float32")
    clock("nystrom f64", nystrom_phase, torch, cuda, serve, "float64")
    runs["fig2"] = clock("fig2", fig2_phase, torch, cuda, checks)
    clock("window f32", window_phase, torch, cuda, serve, 1024, 600, 700,
          "float32", "pallas")
    clock("window f64", window_phase, torch, cuda, serve, 256, 200, 300,
          "float64", "pallas2")
    clock("lifecycle f32", lifecycle_phase, torch, cuda, serve, "float32",
          512, 256, 2000)
    clock("lifecycle f64", lifecycle_phase, torch, cuda, serve, "float64",
          256, 128, 1000, ("--stop-rel-tol", "0"))
    clock("lifecycle_swaps", swap_phase, torch, cuda)
    clock("truncate", truncate_phase, torch, cuda, serve)
    clock("krr", krr_phase, torch, cuda)
    clock("snapshots", snapshots_phase, torch, cuda, nystrom_state)
    del nystrom_state
    clock("reproducible", reproducible_phase, torch, cuda)
    clock("health", health_phase, torch, cuda, serve)
    clock("restore", restore_phase, torch, cuda)
    clock("health_window", guarded_window_phase, torch, cuda, serve)
    clock("health_nystrom", guarded_nystrom_phase, torch, cuda, serve)
    runs["multitenant"], state0 = clock("multitenant", multitenant_phase,
                                        torch, cuda, serve)
    runs["multitenant_cohorts"] = clock(
        "multitenant_cohorts", multitenant_cohorts_phase, torch,
        cuda)["bucket"]
    clock("multitenant_window", multitenant_window_phase, torch, cuda,
          serve)
    clock("decoupled", decoupled_phase, torch, cuda, serve)
    with tempfile.TemporaryDirectory() as tmp:
        single = clock("sharded", sharded_phase, torch, cuda, state0,
                       Path(tmp))
        clock("sharded_p2", sharded_p2_phase, torch, cuda, state0, single,
              Path(tmp) / "p2")
    del state0, single
    runs["roofline"] = clock("roofline", roofline_phase, torch, cuda)
    # Training first, on an empty card (it holds ~50 GB); the serving phases
    # after it ask for no autograd graph.
    torch.cuda.empty_cache()
    runs["lm_train"] = clock("lm_train", lm_train_phase, torch, cuda)
    torch.cuda.empty_cache()
    runs["lm_train_jamba"] = clock("lm_train_jamba", lm_train_jamba_phase,
                                   torch, cuda)
    torch.cuda.empty_cache()
    clock("lm_train_check", lm_train_check_phase, torch, cuda)
    clock("lm_nystrom", lm_nystrom_phase, torch, cuda)
    with torch.inference_mode():
        runs["lm_moe"] = clock("lm_moe", lm_moe_phase, torch, cuda)
        clock("lm_xlstm", lm_xlstm_phase, torch, cuda)
        runs["lm"], prefill_call = clock("lm", lm_phase, torch, cuda)
    timed = clock("timing", timing_phase, torch, checks)
    timed_b = clock("timing_batched", batched_timing_phase, torch, checks)
    with torch.inference_mode():
        clock("lm_profile", lm_profile_phase, checks, prefill_call)
    del prefill_call
    torch.cuda.empty_cache()
    clock.emit()

    print(_smi(), flush=True)
    # Each kernel's launches are read from the run of the path it belongs
    # to (counts reset just before that run): the sequential service for
    # the single rotation and the prologue/projection/transform kernels,
    # the fused-pair service for rotate2, the Fig. 2 loop for scaled_gram,
    # the roofline for rbf_gram, the LM prefill for the LM kernels, the
    # MiniCPM-2B training run for the attention backward, the Jamba
    # training run for the intra-chunk term's backward.
    path_of = {"eigvec_rotate2": "pallas2", "scaled_gram": "fig2",
               "rbf_gram": "roofline", "flash_attention": "lm",
               "ssd_intra_chunk": "lm", "flash_attention_bwd": "lm_train",
               "ssd_intra_chunk_bwd": "lm_train_jamba"}
    main_key_of = {"scaled_gram": ("float64", GRAM_K[0]),   # Fig. 2's type
                   "rbf_gram": ("float32", RBF_SHAPES[0][1]),
                   "flash_attention": (FLASH_SHAPES[0][1],
                                       FLASH_SHAPES[0][0][2]),
                   "flash_attention_bwd": (FLASH_BWD_SHAPES[0][1],
                                           FLASH_BWD_SHAPES[0][0][2]),
                   "ssd_intra_chunk": (SSD_SHAPES[0][1],
                                       SSD_SHAPES[0][0][3]),
                   "ssd_intra_chunk_bwd": (SSD_BWD_SHAPES[0][1],
                                           SSD_BWD_SHAPES[0][0][3])}
    # The batched forms' launches: the multi-tenant service (f32 pallas,
    # B = 8) for the prologue, projection, rotation and transform, the
    # grouped f64 pallas2 cohort for the fused pair.
    batched_path_of = {"eigvec_rotate2": "multitenant_cohorts"}
    kernels = []
    for name, (source, replaces) in checks.SOURCES.items():
        key = (name, *main_key_of.get(name, ("float32", MAIN_M)), "")
        r = timed[key]
        launches = runs[path_of.get(name, "pallas")]["launches"][name]
        if not launches:
            raise AssertionError(f"{name} was not launched on its path")
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": checked[key]["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name in checks.BATCHED:
            rb = timed_b[name, "float32"]
            b_launches = runs[batched_path_of.get(
                name, "multitenant")]["launches"][name]
            if not b_launches:
                raise AssertionError(f"batched {name} was not launched on "
                                     f"its path")
            row["batched"] = {
                "tenants": TENANTS, "m": list(TENANT_MS),
                "launches": b_launches,
                "max_abs_err": checked_b[name, "float32"]["max_abs_err"],
                "bitwise_vs_single":
                    checked_b[name, "float32"]["bitwise_vs_single"],
                "ms": rb["ms"], "singles_ms": rb["singles_ms"],
                "plain_ms": rb["plain_ms"], "bound_ms": rb["bound_ms"],
                "bound_by": rb["bound_by"], "library_ms": rb["library_ms"]}
        kernels.append(row)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
