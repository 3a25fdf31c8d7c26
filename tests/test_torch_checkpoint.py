"""The port's checkpoint store (``checkpoint/npz_store.py``) and its
cross-load with the reference's, both ways.

The layout is the reference's (leaf names, ``manifest.json`` beside
``shard_0.npz``, raw bytes for bf16), so a stream checkpointed by the JAX
package mid-stream continues in the port equal to the JAX run continued
(f64, the streams' 1e-9 bar), and a checkpoint of the port (a window
past its first evictions) loads in the reference's ``load_checkpoint``
bit for bit.  The restore rung of the heal
ladder runs end to end: a poisoned stored row raises ``HealthError``, the
last checkpoint loads, and the replayed tail equals the uninterrupted run
bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import npz_store as jstore  # noqa: E402
from repro.core import inkpca as jink  # noqa: E402
from repro.core import window as jwnd  # noqa: E402
from repro.core import kernels_fn as jkf, rankone as jrk  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import engine as teng, health as thl  # noqa: E402
from repro_torch.core import inkpca as tink, kernels_fn as tkf  # noqa: E402
from repro_torch.core import rankone as trk  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

SIGMA = 5.0
JSPEC, TSPEC = jkf.KernelSpec(sigma=SIGMA), tkf.KernelSpec(sigma=SIGMA)


def _tree():
    return {"params": {"w": torch.arange(12, dtype=torch.float32
                                         ).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "pair": (torch.zeros(2, dtype=torch.float64), None)}


def _equal(a, b):
    return all(x is y is None or torch.equal(x, y) for x, y in
               zip(torch.utils._pytree.tree_leaves(a),
                   torch.utils._pytree.tree_leaves(b)))


def test_roundtrip_and_layout(tmp_path):
    """A nested tree (dicts, a tuple with None, bf16) round-trips; the
    manifest names its leaves as the reference does."""
    d = str(tmp_path)
    save_checkpoint(d, 7, _tree())
    assert latest_step(d) == 7
    out = load_checkpoint(d, 7, _tree())
    assert _equal(out, _tree()) and out["params"]["b"].dtype == torch.bfloat16
    assert out["pair"][1] is None
    assert sorted(os.listdir(os.path.join(d, "step_7"))) == [
        "manifest.json", "shard_0.npz"]
    st = tink.KPCAState(*(torch.zeros(2) for _ in range(6)))
    save_checkpoint(d, 8, {"s": st})
    jst = jink.KPCAState(*(jnp.zeros(2) for _ in range(6)))
    names = [n for n, _ in jstore._flatten_with_names({"s": jst})[0]]
    with open(os.path.join(d, "step_8", "manifest.json")) as f:
        assert [leaf["name"] for leaf in json.load(f)["leaves"]] == names


def test_latest_step_skips_partial_dirs_and_errors(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    for s in (1, 5, 3):
        save_checkpoint(d, s, _tree())
    os.makedirs(os.path.join(d, "step_9.tmp-deadbeef"))
    assert latest_step(d) == 5
    save_checkpoint(d, 6, _tree())
    assert not any(".tmp-" in p for p in os.listdir(d))
    with pytest.raises(KeyError):
        load_checkpoint(d, 6, {"nope": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(d, 6, {**_tree(), "step": torch.zeros(2)})


def test_async_checkpointer_gc_and_error(tmp_path):
    """Saves land in order, garbage collection keeps the last two, and an
    error of the worker (an injected kill) is raised by ``wait``."""
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep=2)
    for s in range(1, 5):
        ck.save(s, _tree())
    ck.wait()
    assert latest_step(d) == 4 and len(os.listdir(d)) == 2
    faults.arm("checkpoint.after_write")
    ck.save(5, _tree())
    with pytest.raises(faults.FaultInjected):
        ck.wait()
    faults.disarm()
    ck.save(6, _tree())
    ck.close()
    assert latest_step(d) == 6


def _same_kpca(tk, jk, atol=1e-9):
    m = int(jk.m)
    assert int(tk.m) == m
    np.testing.assert_allclose(tk.L.numpy()[:m], np.asarray(jk.L)[:m],
                               atol=atol)
    np.testing.assert_allclose(trk.reconstruct(tk.L, tk.U, tk.m).numpy(),
                               np.asarray(jrk.reconstruct(jk.L, jk.U, jk.m)),
                               atol=atol)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """The reference saves its stream mid-stream (a ``KPCAState`` as its
    own tree); the port loads the checkpoint onto its own state and
    continues; the result equals the reference's own continuation."""
    X = np.random.default_rng(9).normal(size=(22, 4))
    js = jink.KPCAStream(jnp.asarray(X[:4]), 32, JSPEC, dtype=jnp.float64)
    for x in X[4:14]:
        js.update(jnp.asarray(x))
    jstore.save_checkpoint(str(tmp_path), 14, js.state)
    ts = tink.KPCAStream(torch.tensor(X[:4]), 32, TSPEC,
                         dtype=torch.float64, device="cpu")
    ts.state = load_checkpoint(str(tmp_path), 14, ts.state)
    assert ts.m_bounds == (14, 14)      # the host count follows the state
    for t, j in zip(ts.state, jax.tree.leaves(js.state)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for x in X[14:]:
        js.update(jnp.asarray(x))
        ts.update(x)
    _same_kpca(ts.kpca_state, js.kpca_state)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """The port saves a windowed stream past its first evictions; the
    reference's ``load_checkpoint`` reads it into its own ``WindowState``
    bit for bit, and the port's loader reads it back alike."""
    X = np.random.default_rng(10).normal(size=(14, 4))
    ts = tink.KPCAStream(torch.tensor(X[:4]), 16, TSPEC, dtype=torch.float64,
                         window=8, device="cpu")
    ts.update_block(torch.tensor(X[4:]))
    save_checkpoint(str(tmp_path), 3, {"window": ts.state})
    jw = jwnd.WindowState(
        kpca=jink.KPCAState(*(jax.ShapeDtypeStruct(tuple(t.shape),
                                                   jnp.dtype(str(t.dtype)
                                                             [6:]))
                              for t in ts.kpca_state)),
        ages=jax.ShapeDtypeStruct((16,), jnp.int64),
        clock=jax.ShapeDtypeStruct((), jnp.int64))
    back = jstore.load_checkpoint(str(tmp_path), 3, {"window": jw})["window"]
    for t, j in zip(torch.utils._pytree.tree_leaves(ts.state),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    again = load_checkpoint(str(tmp_path), 3, {"window": ts.state})
    assert _equal(again["window"], ts.state)


def test_restore_rung_replays_to_the_uninterrupted_run(tmp_path):
    """Poisoned stored rows make the heal ladder raise ``HealthError``;
    the last checkpoint loads, the tail is replayed through the guarded
    stream, and the result equals the uninterrupted run bit for bit."""
    d = str(tmp_path)
    X = np.random.default_rng(11).normal(size=(20, 4))
    plan = teng.UpdatePlan(health=thl.DEFAULT_POLICY, matmul="pallas",
                           fuse_krow=True, dispatch="bucketed", min_bucket=8)

    def stream():
        return tink.KPCAStream(torch.tensor(X[:4]), 32, TSPEC, plan=plan,
                               dtype=torch.float64, device="cpu")

    ref = stream()
    ref.update_block(torch.tensor(X[4:12]))
    save_checkpoint(d, 12, {"kpca": ref.state, "health": ref.health})
    ref.update_block(torch.tensor(X[12:]))

    live = stream()
    live.update_block(torch.tensor(X[4:12]))
    live.state = faults.poison_stored_row(live.state, row=0)
    with pytest.raises(thl.HealthError):
        live.heal(level="resync")
    out = load_checkpoint(d, latest_step(d), {"kpca": live.state,
                                              "health": live.health})
    live.state, live.health = out["kpca"], out["health"]
    live.update_block(torch.tensor(X[12:]))
    assert _equal(live.state, ref.state) and _equal(live.health, ref.health)
