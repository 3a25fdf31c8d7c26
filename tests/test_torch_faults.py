"""The port's fault-injection harness (``testing/faults.py``) and the crash
safety of its checkpoint store, against the reference's.

The killpoint registry behaves as the reference's; the corruptors damage
a torch state exactly as the reference's damage the same numpy state
(the same noise draws, the same bit); and a save killed at every
``faults.trip`` point of ``checkpoint/npz_store.py`` leaves the latest
complete checkpoint loadable, with no debris after the next save.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import inkpca as jink  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.checkpoint import (latest_step, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.core import convert, inkpca as tink  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

KILLPOINTS = ("checkpoint.mid_write", "checkpoint.after_write",
              "checkpoint.between_renames", "checkpoint.after_publish")


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    faults.disarm()


# ------------------------------------------------------------ harness --
def test_trip_is_noop_unless_armed():
    faults.trip("never.armed")
    assert not faults.armed("some.point")


def test_arm_trip_disarm_cycle():
    faults.arm("p1")
    assert faults.armed("p1")
    with pytest.raises(faults.FaultInjected) as ei:
        faults.trip("p1")
    assert ei.value.point == "p1"
    assert not faults.armed("p1")       # disarmed once it fired
    faults.trip("p1")


def test_arm_after_skips_n_hits():
    faults.arm("p2", after=2)
    faults.trip("p2")
    faults.trip("p2")
    with pytest.raises(faults.FaultInjected):
        faults.trip("p2")


def test_injected_scope_disarms_and_is_not_an_exception():
    with pytest.raises(faults.FaultInjected):
        with faults.injected("p3"):
            faults.trip("p3")
    assert not faults.armed("p3")
    with faults.injected("p4"):
        pass
    assert not faults.armed("p4")
    assert not issubclass(faults.FaultInjected, Exception)
    assert issubclass(faults.FaultInjected, BaseException)


# --------------------------------------------------------- corruptors --
@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
def test_nan_point_matches_reference(kind):
    base = np.arange(5.0)
    got = faults.nan_point(5, kind=kind, index=2, base=base)
    want = jfaults.nan_point(5, kind=kind, index=2, base=base)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(faults.nan_point(3), jfaults.nan_point(3))


def _states(dtype):
    X = np.random.default_rng(0).normal(size=(10, 4))
    s = tink.KPCAStream(torch.tensor(X[:4]), 16, tkf.KernelSpec(sigma=3.0),
                        dtype=dtype, device="cpu")
    s.update_block(torch.tensor(X[4:]))
    fields = convert.state_to_numpy(s.state)
    return s.state, jink.KPCAState(**{k: jnp.asarray(v)
                                      for k, v in fields.items()})


def _equal(t, j):
    for k in convert.FIELDS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)


def test_nonfinite_every_poisons_every_kth_point():
    """The services' ``on_point`` helper: points k, 2k, ... (counting from
    1) become non-finite, NaN and inf in turn, each a copy of its point
    with entry 0 replaced; the others pass through as they are."""
    xs = np.random.default_rng(4).normal(size=(9, 3))
    out = [faults.nonfinite_every(3, i, x) for i, x in enumerate(xs)]
    for i, (x, y) in enumerate(zip(xs, out)):
        if (i + 1) % 3:
            assert y.dtype == x.dtype and np.array_equal(y, x)
        else:
            assert np.isfinite(y[1:]).all() and np.array_equal(
                y[1:], x[1:].astype(np.float32))
    assert np.isnan(out[2][0]) and np.isposinf(out[5][0])
    assert np.isnan(out[8][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_corruptors_match_reference(dtype):
    """Each corruptor, on the same state, gives the reference's bits:
    ``corrupt_eigvecs`` (the same draws, only the active block),
    ``bitflip_eigvec`` on sign, exponent and mantissa bits,
    ``corrupt_eigenvalue`` and ``poison_stored_row``."""
    t, j = _states(dtype)
    _equal(faults.corrupt_eigvecs(t, magnitude=0.2, seed=3),
           jfaults.corrupt_eigvecs(j, magnitude=0.2, seed=3))
    top = 63 if dtype == torch.float64 else 31
    for i, jj, bit in ((0, 0, top), (2, 1, top - 1), (3, 3, 5)):
        _equal(faults.bitflip_eigvec(t, i, jj, bit=bit),
               jfaults.bitflip_eigvec(j, i, jj, bit=bit))
    _equal(faults.corrupt_eigenvalue(t, 2, value=-3.5),
           jfaults.corrupt_eigenvalue(j, 2, value=-3.5))
    _equal(faults.poison_stored_row(t, 4), jfaults.poison_stored_row(j, 4))
    # out of place: the input state is untouched
    assert torch.isfinite(t.X).all() and torch.isfinite(t.U).all()
    m = int(t.m)
    bad = faults.corrupt_eigvecs(t, magnitude=0.2)
    assert torch.equal(bad.U[m:], t.U[m:]) and torch.equal(bad.U[:, m:],
                                                           t.U[:, m:])


def test_bitflip_refuses_other_types():
    t, _ = _states(torch.float64)
    with pytest.raises(TypeError):
        faults.bitflip_eigvec(t._replace(U=t.U.half()))


# ---------------------------------------------- crash-safe checkpoints --
def _tree(step):
    return {"w": torch.arange(6, dtype=torch.float32) + step,
            "step": torch.tensor(step, dtype=torch.int32)}


@pytest.mark.parametrize("point", KILLPOINTS)
def test_kill_mid_save_fresh_step(tmp_path, point):
    """A save of step 2 killed at each point (step 1 on disk): the latest
    step is step 1 for a kill before the publish and step 2 after it, and
    it loads intact."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    faults.arm(point)
    if point == "checkpoint.between_renames":
        save_checkpoint(d, 2, _tree(2))    # no old copy to move aside
    else:
        with pytest.raises(faults.FaultInjected):
            save_checkpoint(d, 2, _tree(2))
    step = latest_step(d)
    out = load_checkpoint(d, step, _tree(0))
    assert int(out["step"]) == step
    assert torch.equal(out["w"], torch.arange(6, dtype=torch.float32) + step)
    assert step == (1 if point in ("checkpoint.mid_write",
                                   "checkpoint.after_write") else 2)


@pytest.mark.parametrize("point", KILLPOINTS)
def test_kill_mid_overwrite_same_step(tmp_path, point):
    """An overwrite of step 7 killed at each point: the old or the new
    content loads, never a torn directory."""
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(3))
    save_checkpoint(d, 7, _tree(7))
    new = {"w": torch.full((6,), -1.0), "step": torch.tensor(
        7, dtype=torch.int32)}
    with pytest.raises(faults.FaultInjected):
        with faults.injected(point):
            save_checkpoint(d, 7, new)
    step = latest_step(d)
    assert step in (3, 7)
    w = load_checkpoint(d, step, _tree(0))["w"]
    assert (torch.equal(w, torch.arange(6, dtype=torch.float32) + step)
            or torch.equal(w, new["w"]))


def test_recovery_save_cleans_debris(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    for point in KILLPOINTS:
        faults.arm(point)
        if point == "checkpoint.between_renames":
            save_checkpoint(d, 2, _tree(2))
        else:
            with pytest.raises(faults.FaultInjected):
                save_checkpoint(d, 2, _tree(2))
        faults.disarm()
    save_checkpoint(d, 3, _tree(3))
    names = os.listdir(d)
    assert all(".tmp-" not in n for n in names), names
    assert latest_step(d) == 3


def test_killed_state_save_keeps_the_last_state_loadable(tmp_path):
    """A stream state saved at step 1, a kill mid-write of step 2: the
    state of step 1 loads bit for bit onto the target's device and type."""
    d = str(tmp_path)
    t, _ = _states(torch.float64)
    save_checkpoint(d, 1, t._asdict())
    later = faults.corrupt_eigvecs(t, magnitude=0.1)
    with pytest.raises(faults.FaultInjected):
        with faults.injected("checkpoint.after_write"):
            save_checkpoint(d, 2, later._asdict())
    back = load_checkpoint(d, latest_step(d), t._asdict())
    for k in convert.FIELDS:
        assert torch.equal(back[k], getattr(t, k)), k
