"""A stream started in JAX continues in the port.

The reference runs 20 points, its state crosses over as numpy arrays
(``convert.state_from_numpy``), and both packages continue 20 more points
under the slice's plan in f64.  They agree to ``tests/test_inkpca.py``'s
tolerances (eigenvalues atol 1e-9, S and K1 rtol 1e-10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng, inkpca as jink  # noqa: E402
from repro.core import kernels_fn as jkf  # noqa: E402
from repro_torch.core import convert, engine as teng  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

PLAN = dict(matmul="pallas", fuse_krow=True, dispatch="bucketed",
            min_bucket=16)


def _jax_fields(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in convert.FIELDS}


def test_state_round_trips_exactly():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 3))
    js = jink.KPCAStream(jnp.asarray(X), 16, jkf.KernelSpec(sigma=3.0),
                         dtype=jnp.float64)
    fields = _jax_fields(js.state)
    st = convert.state_from_numpy(fields, device="cpu")
    assert st.m.dtype == torch.int32 and st.m.dim() == 0
    back = convert.state_to_numpy(st)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back[k], fields[k])


def test_jax_stream_continues_in_the_port():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(44, 5))
    sigma = float(np.median(((X[:, None] - X[None]) ** 2).sum(-1)))
    js = jink.KPCAStream(jnp.asarray(X[:4]), 64,
                         jkf.KernelSpec(sigma=sigma),
                         plan=jeng.UpdatePlan(**PLAN), dtype=jnp.float64)
    for x in X[4:24]:
        js.update(jnp.asarray(x))

    st = convert.state_from_numpy(_jax_fields(js.state), device="cpu")
    engine = teng.Engine(tkf.KernelSpec(sigma=sigma), teng.UpdatePlan(**PLAN))
    for i, x in enumerate(X[24:]):
        js.update(jnp.asarray(x))
        st = engine.update(st, torch.tensor(x), m=24 + i)

    m = 44
    assert int(st.m) == int(js.state.m) == m
    np.testing.assert_allclose(np.sort(st.L.numpy()[:m]),
                               np.sort(np.asarray(js.state.L)[:m]),
                               atol=1e-9)
    np.testing.assert_allclose(float(st.S), float(js.state.S), rtol=1e-10)
    np.testing.assert_allclose(st.K1.numpy(), np.asarray(js.state.K1),
                               rtol=1e-10, atol=1e-12)


def test_inconsistent_fields_are_refused():
    fields = {"L": np.zeros(4), "U": np.eye(3), "m": 2, "S": 0.0,
              "K1": np.zeros(4), "X": np.zeros((4, 2))}
    with pytest.raises(ValueError, match="inconsistent"):
        convert.state_from_numpy(fields, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.state_from_numpy({"L": np.zeros(4)}, device="cpu")
