#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line per row:

1. ``build``   — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc (one process per source, all at once) into ``build/``.
2. ``kernels`` — each kernel against its plain PyTorch version on the same
   CUDA inputs (capacity bucket 1024 with m = 1000 and m = 300 for the
   KPCA kernels, the fused pair with deflated columns under a permuted
   cid; n = 4096 rows of width 512 and 200 for ``scaled_gram``; f32 and
   f64; ``rbf_gram`` at the roofline's 1024 x 1024, d = 64 in f32 and f64,
   the Fig. 2 data's full 4096 x 4096 gram, d = 10, in f64 and the ragged
   1000 x 300, d = 16 and 130 x 129, d = 3 in f32), each output entry
   within its own bound as ``repro_torch.kernels.checks`` states it.
3. ``service`` — the KPCA service, ``repro_torch.launch.serve --mode
   kpca`` (Algorithm 2, fused k-row prologue, bucketed dispatch), on the
   sequential route (``--matmul pallas``) and on the fused-pair route
   (``--matmul pallas2``): capacity 1024, d = 16, 4 seed + 1000 streamed
   points in f32, a batch of 64 queries every 16 points; then capacity
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
   W``: f32 on the sequential route at capacity 1024, W = 1000, d = 16,
   4 seed + 1296 points (about 300 steady-state evict + ingest steps at
   the full bucket), queries of 64 every 16 points; f64 on the fused-pair
   route at capacity 256, W = 200, 4 + 396 points.  Launches against the
   reckoning (a growth point as in the service; a steady-state point adds
   the downdate's two inverse pairs: 8 rotations on the sequential route),
   the state's rows exactly the last W streamed points in arrival order
   with consecutive ages, the eigensystem against eigh of those W points,
   and the update latency split into growth and steady state.
7. ``roofline`` — ``repro_torch.launch.roofline`` at the reference
   driver's shapes: a STREAM triad on the card, one row per kernel with
   its rate against it, and the fused-against-unfused ingest and query.
   It is ``rbf_gram``'s path: that kernel's launches are counted around
   it.
8. ``timing`` — at the kernel phase's shapes, each kernel's device time
   (profiler records) beside the plain version's, one library call's and
   its bound, and each call's event-timed time, host work included.  It
   runs last so that the profiler is never attached to a service.

Then the card's name and power limit, the kernels' summary line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_N, MAIN_M = 1024, 1000
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(reports: dict) -> dict:
    """Registers and spill bytes per compiled entry, from ``ptxas -v``."""
    out = {}
    for src, text in reports.items():
        entry = None
        for line in text.splitlines():
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
    bound; returns the rows by (kernel name, dtype, m).  ``launches``
    counts this phase's launches of the kernel; the service's counts start
    from zero after it."""
    rows = {}
    for dtype, n, m, case in all_cases(torch, checks):
        before = cuda.LAUNCHES[case.name]
        res = checks.compare(case)
        row = {"phase": "kernels", "name": case.name,
               "dtype": str(dtype).removeprefix("torch."), "n": n, "m": m,
               **res, "launches": cuda.LAUNCHES[case.name] - before}
        emit(row)
        rows[case.name, row["dtype"], m] = row
    return rows


def all_cases(torch, checks):
    """(dtype, n, m, case) for every kernel at the phases' shapes: the KPCA
    kernels at bucket 1024, scaled_gram at n = 4096 (m is B's width),
    rbf_gram at ``RBF_SHAPES`` and the Fig. 2 data's full gram."""
    from repro_torch.core import kernels_fn as kf
    from repro_torch.data.uci_like import load_dataset

    for dtype in (torch.float32, torch.float64):
        for m in (MAIN_M, 300):
            for case in checks.cases(MAIN_N, m, dtype, "cuda"):
                yield dtype, MAIN_N, m, case
        for k in GRAM_K:
            for case in checks.gram_cases(GRAM_N, k, dtype, "cuda"):
                yield dtype, GRAM_N, k, case
    for n, m, dim, dtype_name in RBF_SHAPES:
        dtype = getattr(torch, dtype_name)
        for case in checks.rbf_gram_cases(n, m, dim, dtype, "cuda"):
            yield dtype, n, m, case
    X = torch.as_tensor(load_dataset("magic", n=GRAM_N, seed=0),
                        device="cuda")
    sigma = float(kf.median_heuristic(X))
    yield torch.float64, GRAM_N, GRAM_N, checks.rbf_gram_case(X, X, sigma)


def timing_phase(torch, checks) -> dict:
    """Each kernel's time beside its plain version's, one library call's
    and its bound, at the shapes of the kernel phase.  Runs after the
    service, so the profiler (CUPTI) is never attached while the main path
    is timed.  ``ms``, ``plain_ms`` and ``library_ms`` are device time per
    call (the profiler's CUDA activity records); the ``*call_ms`` twins
    time whole calls between CUDA events, the wrapper's host work
    included."""
    rows = {}
    for dtype, n, m, case in all_cases(torch, checks):
        ms, per_call = checks.device_ms(case.kernel)
        plain_ms, plain_per_call = checks.device_ms(case.plain)
        bound_ms, bound_by = case.bound(dtype)
        row = {"phase": "timing", "name": case.name,
               "dtype": str(dtype).removeprefix("torch."), "n": n, "m": m,
               "ms": ms, "device_launches_per_call": per_call,
               "call_ms": checks.call_ms(case.kernel),
               "plain_ms": plain_ms,
               "plain_device_launches_per_call": plain_per_call,
               "plain_call_ms": checks.call_ms(case.plain),
               "library_ms": (checks.device_ms(case.library)[0]
                              if case.library else None),
               "library_call_ms": (checks.call_ms(case.library)
                                   if case.library else None),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows[case.name, row["dtype"], m] = row
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
              "scaled_gram": 0, "rbf_gram": 0}
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
    return row


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
              "rbf_gram": 0, **pair_reckoning(launches, grown)}
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
              "scaled_gram": 0, "rbf_gram": 0}
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


def roofline_phase(torch, cuda) -> dict:
    """``launch/roofline.main`` at the reference driver's shapes, nothing
    written; the kernels' launches are counted around it."""
    from repro_torch.launch import roofline

    cuda.reset_launches()
    res = roofline.main(out=None)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    for r in res["kernels"]:
        emit({"phase": "roofline", **r})
    row = {"phase": "roofline", "device": res["device"],
           "peak_gbps": res["peak_gbps"], "triad_bytes": res["triad_bytes"],
           "fused": res["fused"], "launches": launches}
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
    t0 = time.perf_counter()
    info = cuda.build()
    cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "cached": info["cached"],
          "ptxas_registers": ptxas_summary(info.get("ptxas", {}))})

    checked = kernel_phase(torch, checks, cuda)
    runs = {"pallas": service_phase(torch, cuda, serve, 1024, 1000,
                                    "float32", "pallas"),
            "pallas2": service_phase(torch, cuda, serve, 1024, 1000,
                                     "float32", "pallas2")}
    service_phase(torch, cuda, serve, 256, 200, "float64", "pallas")
    service_phase(torch, cuda, serve, 256, 200, "float64", "pallas2")
    nystrom_phase(torch, cuda, serve, "float32")
    nystrom_phase(torch, cuda, serve, "float64")
    runs["fig2"] = fig2_phase(torch, cuda, checks)
    window_phase(torch, cuda, serve, 1024, 1000, 1296, "float32", "pallas")
    window_phase(torch, cuda, serve, 256, 200, 396, "float64", "pallas2")
    runs["roofline"] = roofline_phase(torch, cuda)
    timed = timing_phase(torch, checks)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # Each kernel's launches are read from the run of the path it belongs
    # to (counts reset just before that run): the sequential service for
    # the single rotation and the prologue/projection/transform kernels,
    # the fused-pair service for rotate2, the Fig. 2 loop for scaled_gram,
    # the roofline for rbf_gram.
    path_of = {"eigvec_rotate2": "pallas2", "scaled_gram": "fig2",
               "rbf_gram": "roofline"}
    main_m_of = {"scaled_gram": GRAM_K[0], "rbf_gram": RBF_SHAPES[0][1]}
    kernels = []
    for name, (source, replaces) in checks.SOURCES.items():
        main_m = main_m_of.get(name, MAIN_M)
        key = (name, "float32", main_m)
        r = timed[key]
        launches = runs[path_of.get(name, "pallas")]["launches"][name]
        if not launches:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": checked[key]["max_abs_err"],
                        "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
