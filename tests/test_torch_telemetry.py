"""The port's stream metrics (``core/telemetry.py``, the engine's note
stage) against the reference's, on the same numpy points.

Two properties make the lane free to turn on, and are held here on the
CPU: metered and unmetered streams end bit for bit equal (the note never
touches the eigensystem), and the counters are exact: against a plain
Python tally of a long mixed stream, and each note against the
reference's on the same inputs (f64, capacity 16–32, d = 3–4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import health as jhl, telemetry as jtm  # noqa: E402
from repro_torch.core import engine as teng, health as thl  # noqa: E402
from repro_torch.core import inkpca as tink, kernels_fn as tkf  # noqa: E402
from repro_torch.core import telemetry as ttm  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

TSPEC = tkf.KernelSpec(sigma=2.0)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _drive(stream, X, poison_at=()):
    """Singles for the first half, one block for the rest, with NaN
    points at ``poison_at``."""
    n = X.shape[0]
    for i in range(n // 2):
        x = faults.nan_point(X.shape[1]) if i in poison_at else X[i]
        stream.update(x)
    rest = np.array(X[n // 2:])
    for i in poison_at:
        if 0 <= i - n // 2 < rest.shape[0]:
            rest[i - n // 2] = np.nan
    stream.update_block(torch.tensor(rest))


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("health", [False, True])
def test_metrics_on_off_bitwise_single_stream(window, health):
    """Every leaf of the state (eigensystem, ring, clock) bit for bit equal
    with and without the metric lane, guarded or not, windowed or not;
    the counters account every offered point."""
    X = np.random.default_rng(3).normal(size=(26, 4))
    policy = thl.DEFAULT_POLICY if health else None
    poison = (7, 15) if health else ()
    streams = []
    for metrics in (False, True):
        plan = teng.UpdatePlan(health=policy, metrics=metrics,
                               matmul="pallas", fuse_krow=True,
                               dispatch="bucketed", min_bucket=8)
        s = tink.KPCAStream(torch.tensor(X[:4]), 32, TSPEC,
                            adjusted=not window, plan=plan,
                            dtype=torch.float64, window=window, device="cpu")
        _drive(s, X[4:], poison_at=poison)
        streams.append(s)
    off, on = streams
    assert all(torch.equal(a, b) for a, b in zip(_leaves(off.state),
                                                 _leaves(on.state)))
    assert off.metrics is None and on.metrics is not None
    rep = on.metrics_report()
    assert rep["rejections"] == len(poison)
    assert rep["ingests"] == 22 - len(poison)
    assert rep["m"] == float(on.m) == float(int(on.kpca_state.m))
    assert rep["window_fill"] == (on.m / window if window else -1.0)


def test_counter_oracle_of_a_mixed_stream_and_the_reference():
    """160 offered points through a guarded metered window (a NaN every
    23rd, singles and blocks interleaved) against a Python tally.  (The
    same counters against the reference's on a mixed guarded window:
    ``test_torch_window.py::test_health_and_metrics_bundles_raise``; each
    note against the reference's below.)"""
    rng = np.random.default_rng(5)
    W, d = 12, 3
    s = tink.KPCAStream(torch.tensor(rng.normal(size=(4, d))), 16, TSPEC,
                        adjusted=False,
                        plan=teng.UpdatePlan(health=thl.DEFAULT_POLICY,
                                             window=W, metrics=True),
                        dtype=torch.float64, device="cpu")
    oracle = {"ingests": 0, "rejections": 0, "evictions": 0, "m": 4}
    offered, buf = 0, []

    def offer(x):
        nonlocal offered
        offered += 1
        if not np.isfinite(x).all():
            oracle["rejections"] += 1
            return
        oracle["ingests"] += 1
        if oracle["m"] == W:
            oracle["evictions"] += 1
        else:
            oracle["m"] += 1

    while offered < 160:
        x = rng.normal(size=(d,))
        if offered % 23 == 7:
            x = x * np.nan
        offer(x)
        buf.append(x)
        # a block every 9 points, singles otherwise
        if len(buf) == 9:
            s.update_block(torch.tensor(np.stack(buf)))
            buf = []
        elif offered % 4 == 0:
            for b in buf:
                s.update(b)
            buf = []
    for b in buf:
        s.update(b)
    rep = s.metrics_report()
    for k in ("ingests", "rejections", "evictions"):
        assert rep[k] == oracle[k], k
    assert rep["m"] == float(oracle["m"]) == float(int(s.kpca_state.m))
    assert int(s.state.clock) == oracle["ingests"] + 4


def test_note_helpers_match_the_reference():
    """Each note on the same inputs gives the reference's report, the
    stacked lanes included."""
    tm_, jm = ttm.init_metrics(torch.float64), jtm.init_metrics(jnp.float64)
    th, jh = thl.init_health(torch.float64), jhl.init_health(jnp.float64)
    th = th._replace(orth_err=torch.tensor(3e-4, dtype=torch.float64))
    jh = jh._replace(orth_err=jnp.asarray(3e-4))
    steps = [
        (lambda t: ttm.note_block(t, torch.tensor(5), torch.tensor(8), 4, 3,
                                  th, window=10),
         lambda j: jtm.note_block(j, 5, 8, 4, 3, jh, window=10)),
        (lambda t: ttm.note_block(t, 8, 8, 2, 2),
         lambda j: jtm.note_block(j, 8, 8, 2, 2)),
        (lambda t: ttm.note_downdate(t, torch.tensor(7)),
         lambda j: jtm.note_downdate(j, 7)),
        (lambda t: ttm.note_publish(t, 3), lambda j: jtm.note_publish(j, 3)),
        (ttm.note_skipped_publish, jtm.note_skipped_publish),
        (lambda t: ttm.note_heal(t, "polish"),
         lambda j: jtm.note_heal(j, "polish")),
        (lambda t: ttm.note_heal(t, "resync", 2),
         lambda j: jtm.note_heal(j, "resync", 2)),
        (lambda t: ttm.note_heal(t, "noop"), lambda j: jtm.note_heal(j, "noop")),
        (lambda t: ttm.note_drift(t, 0.25), lambda j: jtm.note_drift(j, 0.25)),
        (lambda t: ttm.note_trace_error(t, 1.5),
         lambda j: jtm.note_trace_error(j, 1.5)),
    ]
    for tstep, jstep in steps:
        tm_, jm = tstep(tm_), jstep(jm)
        assert ttm.metrics_report(tm_) == pytest.approx(
            jtm.metrics_report(jm), abs=1e-15)
    ts, js = ttm.init_metrics_stacked(3), jtm.init_metrics_stacked(3)
    ts = ttm.note_lanes(ts, [1, 0, 2], [0, 1, 0], [0, 0, 1], [5, 4, 6],
                        [-1.0, -1.0, 0.5])
    js = jtm.note_lanes(js, jnp.asarray([1, 0, 2]), jnp.asarray([0, 1, 0]),
                        jnp.asarray([0, 0, 1]), jnp.asarray([5, 4, 6]),
                        jnp.asarray([-1.0, -1.0, 0.5]))
    tr, jr = ttm.metrics_report(ts), jtm.metrics_report(js)
    assert tr.keys() == jr.keys()
    for k in tr:
        np.testing.assert_allclose(np.asarray(tr[k], float),
                                   np.asarray(jr[k], float), err_msg=k)


def test_stream_heal_and_downdate_are_counted():
    """``KPCAStream.heal`` counts its rung and ``downdate`` the removal."""
    X = np.random.default_rng(6).normal(size=(12, 4))
    s = tink.KPCAStream(torch.tensor(X[:4]), 16, TSPEC,
                        plan=teng.UpdatePlan(health=thl.DEFAULT_POLICY,
                                             metrics=True),
                        dtype=torch.float64, device="cpu")
    s.update_block(torch.tensor(X[4:]))
    s.state = faults.corrupt_eigvecs(s.state, magnitude=0.5, seed=2)
    s.heal()
    s.heal(level="polish")
    s.downdate(3)
    rep = s.metrics_report()
    assert (rep["heals_resync"], rep["heals_polish"]) == (1, 1)
    assert rep["downdates"] == 1 and rep["m"] == 11.0 and s.m == 11
    engine = teng.Engine(TSPEC)
    st, ms = engine.downdate_metered(s.state, ttm.init_metrics(torch.float64),
                                     0)
    assert ttm.metrics_report(ms)["downdates"] == 1 and int(st.m) == 10
