"""Run the row-sharded builders (``core/distributed.py``) on P processes.

``launch(world, jobs, workdir=...)`` starts ``world`` processes of this
module, each a rank of one ``torch.distributed`` world that meets through
a ``FileStore`` in ``workdir``, runs the same list of jobs, and writes its
outputs; ``launch`` waits for all of them within ``timeout`` seconds (and
kills them past it, so a mismatched collective schedule fails instead of
hanging) and returns each rank's outputs.  ``run_jobs`` runs the jobs in
an already joined world (one process: the caller's own).

A job is a dict: ``kind`` (a key of ``JOBS``), ``plan`` (``UpdatePlan``
fields), and its inputs as replicated tensors — full U matrices, from
which each rank takes its row block, stacked tenants, from which each
tenant slice takes its own.  Each job returns this rank's outputs (row
blocks, replicated vectors), the kernel launches it made, its seconds and
the collectives it issued.  A rank also reports whether anything of
``jax`` or of the reference package was loaded in it.

    python -m repro_torch.testing.spmd --rank R --world P --store PATH \\
        --jobs JOBS.pt --out OUT.pt [--backend gloo] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

DEFAULT_TIMEOUT = 120.0


def _plan(job):
    from repro_torch.core import engine as eng
    from repro_torch.core import health as hl

    kw = dict(job.get("plan", {}))
    if kw.pop("health", False):
        kw["health"] = hl.DEFAULT_POLICY
    return eng.UpdatePlan(**kw)


def _spec(job):
    from repro_torch.core import kernels_fn as kf
    return kf.KernelSpec(name="rbf", sigma=float(job.get("sigma", 1.0)))


def _rows(U, comm):
    """This rank's row block of a replicated (..., M, M) matrix."""
    R = U.shape[-2] // comm.size
    return U[..., comm.rank * R:(comm.rank + 1) * R, :].contiguous()


def _vec_rows(v, comm):
    R = v.shape[-1] // comm.size
    return v[..., comm.rank * R:(comm.rank + 1) * R].contiguous()


def _job_update(job, comm, dev):
    from repro_torch.core import distributed as dist

    fn = dist.make_sharded_update(comm, plan=_plan(job))
    L, U = job["L"], _rows(job["U"], comm)
    for v, s in zip(job["V"], job["S"]):
        L, U = fn(L, U, _vec_rows(v, comm), s, job["m"])
    return {"L": L, "U": U}


def _job_pair(job, comm, dev):
    from repro_torch.core import distributed as dist

    fn = dist.make_sharded_update_pair(comm, plan=_plan(job))
    L, U = job["L"], _rows(job["U"], comm)
    for v1, s1, v2, s2 in zip(job["V1"], job["S1"], job["V2"], job["S2"]):
        L, U = fn(L, U, _vec_rows(v1, comm), s1, _vec_rows(v2, comm), s2,
                  job["m"])
    return {"L": L, "U": U}


def _job_downdate(job, comm, dev):
    from repro_torch.core import distributed as dist

    fn = dist.make_sharded_downdate(comm, plan=_plan(job))
    L, U, m = fn(job["L"], _rows(job["U"], comm), job["a"], job["k_new"],
                 job["m"])
    return {"L": L, "U": U, "m": m}


def _job_evict(job, comm, dev):
    from repro_torch.core import distributed as dist

    fn = dist.make_sharded_evict(comm, plan=_plan(job))
    L, U, m = fn(job["L"], _rows(job["U"], comm), job["a"], job["k_new"],
                 job["i"], job["m"])
    return {"L": L, "U": U, "m": m}


def _job_window(job, comm, dev):
    from repro_torch.core import distributed as dist
    from repro_torch.core import telemetry as tm

    plan, spec = _plan(job), _spec(job)
    args = (job["L"], _rows(job["U"], comm), job["X"], job["ages"],
            job["clock"])
    if job.get("metered"):
        fn = dist.make_sharded_window_block_metered(comm, spec, plan=plan)
        ms = tm.init_metrics(job["L"].dtype, dev)
        out = fn(*args, job["xs"], job["m"], ms)
        names = ("L", "U", "X", "ages", "clock")
        res = dict(zip(names, out[:5]))
        res["metrics"] = tm.metrics_report(out[5])
        return res
    fn = dist.make_sharded_window_block(comm, spec, plan=plan)
    block = job.get("block") or len(job["xs"])
    for t0 in range(0, len(job["xs"]), block):
        args = fn(*args, job["xs"][t0:t0 + block], job["m"])
    return dict(zip(("L", "U", "X", "ages", "clock"), args))


def _job_expand(job, comm, dev):
    from repro_torch.core import distributed as dist

    L, U, m = dist.make_sharded_expand(comm)(job["L"], _rows(job["U"], comm),
                                             job["lam"], job["m"])
    return {"L": L, "U": U, "m": m}


def _job_gram_row(job, comm, dev):
    from repro_torch.core import distributed as dist

    fn = dist.sharded_gram_row(comm, _spec(job))
    return {"a": fn(_rows(job["X"], comm), job["x_new"])}


def _job_rebalanced(job, comm, dev):
    from repro_torch.core import distributed as dist

    fn = dist.make_rebalanced_update(comm, plan=_plan(job))
    L, U = fn(job["L"], _rows(job["U"], comm), job["v"], job["sigma"],
              job["m"])
    return {"L": L, "U": U}


def _tenant_slice(x, mesh):
    own = mesh.tenants(x.shape[0])
    return x[own.start:own.stop].contiguous()


def _job_tenant_pair(job, mesh, dev):
    from repro_torch.core import distributed as dist

    fn = dist.make_tenant_update_pair(mesh, plan=_plan(job))
    t = lambda k: _tenant_slice(job[k], mesh)          # noqa: E731
    L, U = fn(t("L"), _rows(t("U"), mesh.rows), _vec_rows(t("V1"), mesh.rows),
              t("S1"), _vec_rows(t("V2"), mesh.rows), t("S2"), t("m"))
    return {"L": L, "U": U}


def _job_tenant_query(job, mesh, dev):
    from repro_torch.core import distributed as dist
    from repro_torch.core import serving

    snap = job["snaps"]
    aff = snap.get("affine")
    snaps = serving.ServingSnapshot(
        S=_tenant_slice(snap["S"], mesh), X=_tenant_slice(snap["X"], mesh),
        m=_tenant_slice(snap["m"], mesh),
        affine=None if aff is None else serving.AffineCorrection(
            *(_tenant_slice(f, mesh) for f in aff)),
        generation=_tenant_slice(snap["generation"], mesh))
    fn = dist.make_tenant_query(mesh, _spec(job), plan=_plan(job))
    return {"y": fn(snaps, _tenant_slice(job["xq"], mesh))}


def _job_decoupled(job, mesh, dev):
    """``serve --decouple --mesh`` on this world; returns the gathered
    report and this rank's answers, one per query batch."""
    from repro_torch.launch import serve

    args = serve.parse_args(job["argv"])
    answers = []
    orig = serve.IngestServeLoop.query

    def query(self, q):
        y = orig(self, q)
        answers.append(y)
        return y

    serve.IngestServeLoop.query = query
    result, loop = serve.kpca_decoupled_service(args)
    serve.IngestServeLoop.query = orig
    return {"result": result,
            "answers": torch.stack(answers) if answers else None,
            "m_final": loop.batch.states.m}


def _job_compressed_psum(job, comm, dev):
    """``optim.compressed_psum`` over the default group for each step of
    ``job["grads"]`` (a list over steps of a list over ranks of gradient
    dicts; this rank takes its own), carrying the error feedback; returns
    each step's means and the last residual."""
    import torch.distributed as tdist

    from repro_torch.optim import compression

    rank = tdist.get_rank()
    state = compression.init_state(job["grads"][0][rank])
    means = []
    for per_rank in job["grads"]:
        mean, state = compression.compressed_psum(per_rank[rank], state)
        means.append(mean)
    return {"means": means, "error": state.error}


JOBS = {"update": _job_update, "pair": _job_pair, "downdate": _job_downdate,
        "evict": _job_evict, "window": _job_window, "expand": _job_expand,
        "gram_row": _job_gram_row, "rebalanced": _job_rebalanced,
        "tenant_pair": _job_tenant_pair, "tenant_query": _job_tenant_query,
        "decoupled": _job_decoupled,
        "compressed_psum": _job_compressed_psum}
# Jobs that take the tenant mesh (job["mesh"] = (P_t, P_r)), not a row
# group.
MESH_JOBS = ("tenant_pair", "tenant_query", "decoupled")


def _to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_jobs(jobs: list, *, device="cpu", timeout=DEFAULT_TIMEOUT) -> list:
    """Run ``jobs`` on this rank of the joined default group; each job's
    outputs (on the CPU) with ``launches`` (the kernel launches it made),
    ``seconds`` and ``collectives`` (all-reduces this rank issued)."""
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import cuda

    dev = torch.device(device)
    world = None
    outs = []
    for job in jobs:
        job = _to(job, dev)
        if job["kind"] in MESH_JOBS:
            pt, pr = job.get("mesh", (1, 1))
            comm = dist.make_tenant_mesh(pt, pr, device=dev,
                                         timeout=timeout)
            counter = comm.rows
        else:
            if world is None:
                world = dist.row_group(device=dev, timeout=timeout)
            comm = counter = world
        c0 = counter.collectives
        counter.row_offsets.clear()
        before = dict(cuda.LAUNCHES)
        _sync(dev)
        t0 = time.perf_counter()
        out = JOBS[job["kind"]](job, comm, dev)
        _sync(dev)
        out = _cpu(out)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = {k: v - before[k] for k, v in cuda.LAUNCHES.items()
                           if v != before[k]}
        out["collectives"] = counter.collectives - c0
        out["staging"] = counter.staging
        out["row_offsets"] = sorted(counter.row_offsets)
        outs.append(out)
    return outs


def reference_loaded() -> bool:
    """Whether anything of ``jax`` or of the reference package is
    loaded in this process."""
    return any(k in ("jax", "jaxlib", "repro") or k.startswith(
        ("jax.", "jaxlib.", "repro.")) for k in sys.modules)


class Launch:
    """Ranks started by ``start``; ``wait`` collects them."""

    def __init__(self, procs, workdir: Path, timeout: float):
        self.procs = procs
        self.workdir = workdir
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self) -> list[dict]:
        """Each rank's ``{"outs": [...], "reference_loaded": bool,
        "rank": r}``.  Raises as soon as a rank fails (its peers would wait
        in a collective) or when the ranks are not done by the deadline;
        the other ranks are killed then."""
        while True:
            codes = [p.poll() for p in self.procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > self.deadline
            if failed or late:
                for p in self.procs:
                    p.kill()
                    p.wait()
                if failed:
                    logs = [(self.workdir / f"log{r}.txt").read_text()[-3000:]
                            for r in failed]
                    raise RuntimeError(f"spmd ranks {failed} failed:\n"
                                       + "\n".join(logs))
                raise TimeoutError(f"spmd ranks not done within "
                                   f"{self.timeout} s")
            if all(c == 0 for c in codes):
                return [torch.load(self.workdir / f"out{r}.pt",
                                   weights_only=False)
                        for r in range(len(self.procs))]
            time.sleep(0.05)


def start(world: int, jobs: list, *, workdir, backend: str = "gloo",
          device: str = "cpu", timeout: float = DEFAULT_TIMEOUT,
          env: dict | None = None) -> Launch:
    """Start ``world`` fresh processes of this module running ``jobs``;
    returns at once (``Launch.wait`` collects them)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    jobs_path = workdir / "jobs.pt"
    torch.save(_cpu(jobs), jobs_path)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    src = str(Path(__file__).resolve().parents[2])
    penv = {**os.environ, **(env or {})}
    penv["PYTHONPATH"] = src + os.pathsep + penv.get("PYTHONPATH", "")
    procs = []
    for r in range(world):
        cmd = [sys.executable, "-m", "repro_torch.testing.spmd",
               "--rank", str(r), "--world", str(world), "--store", str(store),
               "--jobs", str(jobs_path), "--out", str(workdir / f"out{r}.pt"),
               "--backend", backend, "--device", device,
               "--timeout", str(timeout)]
        with open(workdir / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(cmd, env=penv, stdout=log,
                                          stderr=subprocess.STDOUT))
    return Launch(procs, workdir, timeout)


def launch(world: int, jobs: list, **kw) -> list[dict]:
    """``start`` then ``wait``: run ``jobs`` on ``world`` fresh ranks."""
    return start(world, jobs, **kw).wait()


def main(argv=None) -> int:
    import torch.distributed as tdist

    from repro_torch.core import distributed as dist

    ap = argparse.ArgumentParser(description="one rank of an spmd launch")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cpu":
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // a.world))
    if dev.type == "cuda":
        from repro_torch import resolve_device
        resolve_device(dev)
        if dev.index is not None:
            torch.cuda.set_device(dev)
    dist.init_world(rank=a.rank, world_size=a.world, backend=a.backend,
                    store=tdist.FileStore(a.store, a.world),
                    timeout=a.timeout)
    jobs = torch.load(a.jobs, weights_only=False)
    outs = run_jobs(jobs, device=dev, timeout=a.timeout)
    torch.save({"outs": outs, "reference_loaded": reference_loaded(),
                "rank": a.rank}, a.out)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
