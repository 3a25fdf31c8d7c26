"""The port's Nyström attention (``repro_torch.models.nystrom_attention``)
against the reference's, after its own ``tests/test_nystrom_attention.py``:
the chunk-causal prefill, the O(m) decode, ``grow_landmark`` (Algorithm 1
on the landmark gram) and ``ginv_from_eig``, on the same numpy inputs and
the reference's parameter tree (``convert.load_numpy_``).

Tolerances: prefill and decode in float32 at 1e-5 of the output's largest
magnitude (the same formula, float32 sums in other orders; the jittered
inverse of a gram near the identity); ``grow_landmark`` in float64 at the
reference test's own bars (eigenvalues 1e-8 off eigh, G⁻¹ at rtol 1e-6).
The LM's routing of Nyström layers is held to the reference in
``test_torch_train.py`` (loss and gradients of a Nyström config) and
``test_torch_models.py`` (prefill against decode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import inkpca as jinkpca  # noqa: E402
from repro.core import kernels_fn as jkf  # noqa: E402
from repro.models import nystrom_attention as jnys  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import kernels_fn as tkf  # noqa: E402
from repro_torch.models import nystrom_attention as tnys  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

RTOL = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab=64, attention="nystrom",
                nystrom_landmarks=16, dtype="float32")
    base.update(kw)
    return JArchConfig(**base), ArchConfig(**base)


def _params(jcfg, tcfg, seed=0):
    jp = jnys.nystrom_attention_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.load_numpy_(tnys.NystromAttention(tcfg, "meta"),
                             jax.tree.map(np.asarray, jp), "cpu")
    assert tp.landmarks.dtype == torch.float32
    return jp, tp


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("chunk,T", [(8, 32), (16, 16), (0, 32)])
def test_prefill_matches_reference(chunk, T):
    """Four chunks (the (Ψ, ζ, β) carry re-based three times), one chunk
    (exact attention), and the default chunk max(m, 128) cut to T."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    x = np.random.default_rng(T + chunk).normal(size=(2, T, 32)).astype(
        np.float32) * 2.0
    pos = np.broadcast_to(np.arange(T)[None], (2, T))
    want = jax.jit(lambda p, x, pos: jnys.nystrom_attention_apply(
        p, jcfg, x, pos, chunk=chunk))(jp, jnp.asarray(x), jnp.asarray(pos))
    got = tnys.nystrom_attention_apply(tp, tcfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()),
                                       chunk=chunk)
    _close(got, want)
    # Chunk causality: a change to the last chunk leaves the others.
    if chunk == 8:
        x2 = x.copy()
        x2[:, -8:] += 1.0
        got2 = tnys.nystrom_attention_apply(tp, tcfg, torch.from_numpy(x2),
                                            torch.from_numpy(pos.copy()),
                                            chunk=chunk)
        assert torch.equal(got[:, :-8], got2[:, :-8])


def test_decode_matches_reference_step_by_step():
    """Six decode steps from the initial cache: outputs and every cache
    field, whose shapes stay independent of the context length."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    jc, tc = jnys.nystrom_cache_init(jp, jcfg, 2), \
        tnys.nystrom_cache_init(tp, tcfg, 2)
    _close(tc.ginv, jc.ginv)
    rng = np.random.default_rng(3)
    jstep = jax.jit(lambda p, x, c, pos: jnys.nystrom_decode(p, jcfg, x, c,
                                                             pos))
    for t in range(6):
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        jy, jc = jstep(jp, jnp.asarray(x), jc, jnp.full((2, 1), t, jnp.int32))
        ty, tc = tnys.nystrom_decode(tp, tcfg, torch.from_numpy(x), tc,
                                     torch.full((2, 1), t))
        _close(ty, jy)
        for f in ("psi", "zeta", "beta"):
            _close(getattr(tc, f), getattr(jc, f))
        assert tc.psi.shape == (2, 2, 16, tcfg.hd)


def _grown(M=12, m0=6, hd=8, grows=2, seed=9):
    """The reference's and the port's (landmarks, L, U, m) after ``grows``
    calls of ``grow_landmark`` from the same f64 batch state."""
    rng = np.random.default_rng(seed)
    sigma = 2.0 * np.sqrt(hd)
    lms = np.zeros((M, hd))
    lms[:m0] = rng.normal(size=(m0, hd))
    spec = jkf.KernelSpec(name="rbf", sigma=float(sigma))
    st = jinkpca.init_state(jnp.asarray(lms[:m0]), M, spec, adjusted=False,
                            dtype=jnp.float64)
    j = (jnp.asarray(lms), st.L, st.U, st.m)
    t = (torch.tensor(lms), torch.tensor(np.asarray(st.L)),
         torch.tensor(np.asarray(st.U)), torch.tensor(int(st.m)))
    news = rng.normal(size=(grows, hd))
    jgrow = jax.jit(lambda X, L, U, m, x: jnys.grow_landmark(X, L, U, m, x,
                                                             sigma))
    for x in news:
        j = jgrow(*j, jnp.asarray(x))
        t = tnys.grow_landmark(*t, torch.tensor(x), sigma)
    return j, t, lms[:m0], news, sigma


def test_grow_landmark_matches_reference_and_batch_eigh():
    """Two landmarks added by Algorithm 1 (the rotation kernel's route on
    the CPU): the port's eigenvalues equal the reference's and eigh of the
    grown landmark gram (1e-8), the buffer holds the new rows, and
    ``ginv_from_eig`` is the gram's inverse (the reference test's
    bars)."""
    (jX, jL, jU, jm), (tX, tL, tU, tm), seed_rows, news, sigma = _grown()
    m = len(seed_rows) + len(news)
    assert int(tm) == int(jm) == m
    assert np.array_equal(tX.numpy(), np.asarray(jX))
    grown = np.vstack([seed_rows, news])
    G = tkf.gram_block(torch.tensor(grown), torch.tensor(grown),
                       spec=tkf.KernelSpec(name="rbf",
                                           sigma=float(sigma))).numpy()
    lam_ref = np.linalg.eigh(G)[0]
    np.testing.assert_allclose(np.sort(tL[:m].numpy()), lam_ref, atol=1e-8)
    np.testing.assert_allclose(np.sort(tL[:m].numpy()),
                               np.sort(np.asarray(jL[:m])), atol=1e-8)
    Ginv = tnys.ginv_from_eig(tL, tU, tm, jitter=0.0).numpy()
    np.testing.assert_allclose(Ginv[:m, :m], np.linalg.inv(G), rtol=1e-6,
                               atol=1e-8)
    _close(Ginv, np.asarray(jnys.ginv_from_eig(jL, jU, jm, jitter=0.0)),
           1e-8)
    # With the default jitter, eigenvalues below it are cut as in the
    # reference.
    _close(tnys.ginv_from_eig(tL, tU, tm),
           np.asarray(jnys.ginv_from_eig(jL, jU, jm)), 1e-8)
