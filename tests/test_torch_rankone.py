"""The port's rank-one update against the reference's, on the same inputs.

Both routes of the port run: ``"jnp"`` (dense factor) and ``"pallas"``
(the rotation kernel's plain version, which is the CPU route), each held
against the same route of the reference.  Tolerances are
``tests/test_rankone.py``'s: 1e-10 in f64 for eigenvalues and the
reconstruction, and its orthogonality bars (1e-8 generic, 1e-9 after a
cluster merge).  On clustered spectra, where the reference is at fault,
the port is held to orthogonality and reconstruction bars instead.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import rankone as jr  # noqa: E402
from repro_torch.core import rankone as tr  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401


def _padded(lam, vec, M):
    m = lam.shape[0]
    L = np.zeros(M)
    U = np.eye(M)
    L[:m] = lam
    U[:m, :m] = vec
    L = np.asarray(jr.sentinelize(jnp.asarray(L), jnp.int32(m),
                                  jnp.float64(0.0)))
    return L, U


def _system(kind, m, M, seed):
    """(L, U, v): a generic, clustered or deflating padded eigensystem and
    an update vector."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        lam = np.sort(np.concatenate([2.0 + rng.normal(size=4) * 1e-14,
                                      rng.uniform(3.0, 6.0, size=m - 4)]))
        vec = np.linalg.qr(rng.normal(size=(m, m)))[0]
    else:
        A = rng.normal(size=(m, m))
        lam, vec = np.linalg.eigh(A @ A.T)
    L, U = _padded(lam, vec, M)
    v = np.zeros(M)
    if kind == "deflating":
        # v has no component along three eigenvectors: z_i = 0 there.
        z = rng.normal(size=m)
        z[[0, 3, m - 1]] = 0.0
        v[:m] = vec @ z
    else:
        v[:m] = rng.normal(size=m)
    return L, U, v


def _run_both(L, U, v, sigma, m, matmul, dtype=np.float64):
    jl, ju = jr.rank_one_update(jnp.asarray(L, dtype), jnp.asarray(U, dtype),
                                jnp.asarray(v, dtype), jnp.asarray(sigma,
                                                                   dtype),
                                jnp.int32(m), matmul=matmul)
    tl, tu = tr.rank_one_update(torch.tensor(L, dtype=_T[dtype]),
                                torch.tensor(U, dtype=_T[dtype]),
                                torch.tensor(v, dtype=_T[dtype]), sigma, m,
                                matmul=matmul)
    return (np.asarray(jl), np.asarray(ju)), (tl.numpy(), tu.numpy())


_T = {np.float64: torch.float64, np.float32: torch.float32}


def _recon(L, U, m):
    return (U[:m, :m] * L[:m]) @ U[:m, :m].T


@pytest.mark.parametrize("matmul", ["jnp", "pallas"])
@pytest.mark.parametrize("sigma", [1.3, -0.8])
@pytest.mark.parametrize("kind", ["generic", "clustered", "deflating"])
def test_rank_one_update_matches_reference(kind, sigma, matmul):
    m, M = 10, 16
    L, U, v = _system(kind, m, M, seed=7)
    if kind == "clustered":          # the dlaed2 merge path is exercised
        assert bool(jr._merge_fires(jnp.asarray(L), jnp.asarray(U.T @ v),
                                    jnp.float64(sigma), jnp.int32(m)))
    (jl, ju), (tl, tu) = _run_both(L, U, v, sigma, m, matmul)
    np.testing.assert_allclose(tl, jl, atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(_recon(tl, tu, m), _recon(jl, ju, m),
                               atol=1e-10)
    # Padding invariants: identity on inactive columns, sentinels on top.
    np.testing.assert_array_equal(tu[:, m:], np.eye(M)[:, m:])
    assert tl[m:].min() > tl[:m].max()
    G = tu[:m, :m].T @ tu[:m, :m]
    bar = 1e-9 if kind == "clustered" else 1e-8
    assert np.abs(G - np.eye(m)).max() < bar
    if kind != "clustered":          # unique eigenvectors: same up to sign
        np.testing.assert_allclose(np.abs(tu), np.abs(ju), atol=1e-10)


@pytest.mark.parametrize("sigma", [0.5, -4.0])
@pytest.mark.parametrize("m,M", [(6, 8), (10, 10), (17, 32)])
def test_rank_one_update_matches_eigh(sigma, m, M):
    L, U, v = _system("generic", m, M, seed=m)
    tl, tu = tr.rank_one_update(torch.tensor(L), torch.tensor(U),
                                torch.tensor(v), sigma, m, matmul="pallas")
    B = _recon(L, U, m) + sigma * np.outer(v[:m], v[:m])
    np.testing.assert_allclose(np.sort(tl.numpy()[:m]), np.linalg.eigh(B)[0],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(_recon(tl.numpy(), tu.numpy(), m), B,
                               rtol=1e-8, atol=1e-8)


def test_rank_one_update_f32_state_matches_reference():
    """An f32 state solves its secular equations in f64 in both packages
    (``precise``); the rotation itself rounds in f32."""
    m, M = 12, 16
    L, U, v = _system("generic", m, M, seed=3)
    (jl, ju), (tl, tu) = _run_both(L, U, v, 0.9, m, "pallas", np.float32)
    assert tl.dtype == np.float32
    scale = np.abs(jl[:m]).max()
    np.testing.assert_allclose(tl[:m], jl[:m], atol=2e-5 * scale)
    np.testing.assert_allclose(np.abs(tu), np.abs(ju), atol=1e-4)


def test_zero_update_stays_finite():
    m, M = 6, 8
    L, U, _ = _system("generic", m, M, seed=1)
    tl, tu = tr.rank_one_update(torch.tensor(L), torch.tensor(U),
                                torch.zeros(M, dtype=torch.float64), 2.0, m)
    assert torch.isfinite(tl).all() and torch.isfinite(tu).all()
    np.testing.assert_allclose(tl.numpy()[:m], L[:m], atol=1e-12)


@pytest.mark.parametrize("m,M", [(5, 8), (0, 4), (7, 8)])
def test_expand_eigensystem_matches_reference(m, M):
    rng = np.random.default_rng(m)
    if m:
        A = rng.normal(size=(m, m))
        lam, vec = np.linalg.eigh(A @ A.T)
    else:
        lam, vec = np.zeros(0), np.zeros((0, 0))
    L, U = _padded(lam, vec, M)
    jl, ju, jm = jr.expand_eigensystem(jnp.asarray(L), jnp.asarray(U),
                                       jnp.float64(0.33), jnp.int32(m))
    tl, tu, tm = tr.expand_eigensystem(
        torch.tensor(L), torch.tensor(U), torch.tensor(0.33, dtype=torch.float64),
        torch.tensor(m, dtype=torch.int32))
    assert int(tm) == int(jm) == m + 1 and tm.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(
        tr.reconstruct(tl, tu, tm).numpy(),
        np.asarray(jr.reconstruct(jl, ju, jm)), atol=1e-12)


def test_sentinelize_and_secular_pieces_match_reference():
    rng = np.random.default_rng(11)
    M, m = 12, 8
    d = np.sort(rng.normal(size=M))
    for room in (0.0, 2.5):
        np.testing.assert_array_equal(
            tr.sentinelize(torch.tensor(d), torch.tensor(m), torch.tensor(room,
                           dtype=torch.float64)).numpy(),
            np.asarray(jr.sentinelize(jnp.asarray(d), jnp.int32(m),
                                      jnp.float64(room))))
    z = rng.normal(size=M)
    defl = np.arange(M) % 4 == 1
    np.testing.assert_allclose(
        tr._secular_bisect(torch.tensor(d), torch.tensor(z * z),
                           torch.tensor(1.7, dtype=torch.float64), 62,
                           defl=torch.tensor(defl)).numpy(),
        np.asarray(jr._secular_bisect(jnp.asarray(d), jnp.asarray(z * z),
                                      jnp.float64(1.7), 62,
                                      defl=jnp.asarray(defl))),
        atol=1e-13)
    dc = d.copy()
    dc[3:6] = dc[3]
    zt, _, fired_t = tr._cluster_merge(torch.tensor(dc), torch.tensor(z),
                                       torch.tensor(1e-12, dtype=torch.float64))
    zj, _, fired_j = jr._cluster_merge(jnp.asarray(dc), jnp.asarray(z),
                                       jnp.float64(1e-12))
    assert bool(fired_t) and bool(fired_j)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-14)


# ------------------------------------------------ clustered spectra -----
# The reference's own property (tests/test_rankone.py::
# test_pair_merge_fallback_property) draws near-degenerate spectra: a
# cluster of 2-6 eigenvalues near 2.0 of width 1e-12 ... 1e-16 among
# others in [3, 6], m = 9, M = 12, f64.  The port's update is held after
# each of a +sigma and a -sigma update to ‖UᵀU - I‖max < 1e-9 and
# ‖U diag(L) Uᵀ - (A + sigma vvᵀ)‖max <= 1e-9·‖A‖₂ (ROADMAP.md, "Faults
# found": the reference misses both at seed=729, n_cluster=5, sigma=0.7).
def _clustered(seed, n_cluster, width, m=9, M=12):
    rng = np.random.default_rng(seed)
    lam = np.sort(np.concatenate([2.0 + rng.normal(size=n_cluster) * width,
                                  rng.uniform(3.0, 6.0, size=m - n_cluster)]))
    vec, _ = np.linalg.qr(rng.normal(size=(m, m)))
    L, U = _padded(lam, vec, M)
    v1, v2 = np.zeros(M), np.zeros(M)
    v1[:m] = rng.normal(size=m)
    v2[:m] = rng.normal(size=m)
    return L, U, v1, v2


def _pair_errors(L, U, v1, v2, sigma, m, step):
    """Largest orthogonality and relative reconstruction error over the
    two updates (+sigma, then -sigma) that ``step`` applies."""
    worst_orth = worst_rec = 0.0
    A = _recon(L, U, m)
    for v, s in ((v1, sigma), (v2, -sigma)):
        L, U = step(L, U, v, s)
        A_new = A + s * np.outer(v[:m], v[:m])
        G = U[:m, :m].T @ U[:m, :m]
        worst_orth = max(worst_orth, np.abs(G - np.eye(m)).max())
        worst_rec = max(worst_rec, np.abs(_recon(L, U, m) - A_new).max()
                        / np.linalg.norm(A, 2))
        A = A_new
    return worst_orth, worst_rec


def _port_step(matmul, m):
    def step(L, U, v, s):
        tl, tu = tr.rank_one_update(torch.tensor(L), torch.tensor(U),
                                    torch.tensor(v), s, m, matmul=matmul)
        return tl.numpy(), tu.numpy()
    return step


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), n_cluster=st.integers(2, 6),
       width_exp=st.integers(12, 16), sigma=st.sampled_from([0.7, -0.7, 2.5]),
       matmul=st.sampled_from(["jnp", "pallas"]))
def test_clustered_updates_stay_orthogonal_and_exact(seed, n_cluster,
                                                     width_exp, sigma,
                                                     matmul):
    m = 9
    L, U, v1, v2 = _clustered(seed, n_cluster, 10.0 ** -width_exp, m=m)
    orth, rec = _pair_errors(L, U, v1, v2, sigma, m, _port_step(matmul, m))
    assert orth < 1e-9 and rec <= 1e-9


def test_reference_loses_orthogonality_on_a_cluster_where_the_port_does_not():
    """Witness of the reference's fault (ROADMAP.md, "Faults found"): at
    the reference property's falsifying example its second update returns
    ‖UᵀU - I‖max = 0.707 (0.707 when written); the port's stays under
    1e-9 with its reconstruction within 1e-9·‖A‖.  Once the reference is
    fixed, this test fails and goes with the fix."""
    m, seed, n_cluster, sigma = 9, 729, 5, 0.7
    width = 10.0 ** -np.random.default_rng(seed).integers(12, 16)
    L, U, v1, v2 = _clustered(seed, n_cluster, width, m=m)

    def ref_step(L, U, v, s):
        jl, ju = jr.rank_one_update(jnp.asarray(L), jnp.asarray(U),
                                    jnp.asarray(v), jnp.float64(s),
                                    jnp.int32(m))
        return np.asarray(jl), np.asarray(ju)

    ref_orth, ref_rec = _pair_errors(L, U, v1, v2, sigma, m, ref_step)
    assert ref_orth > 0.1 and ref_rec > 1e-5
    for matmul in ("jnp", "pallas"):
        orth, rec = _pair_errors(L, U, v1, v2, sigma, m,
                                 _port_step(matmul, m))
        assert orth < 1e-9 and rec <= 1e-9
