"""The attention backward's contract with the forward's log-sum-exp.

The bfloat16 forward kernel writes each row's log-sum-exp, in its base-2
units, when a gradient will be taken, and the bfloat16 backward reads it.
Their plain versions are held here to the reference's attention
(``src/repro/models/layers.py`` ``_naive_attention``: q·k/sqrt(hd) under
the causal mask), and the backward's bfloat16 bound to a more accurate
evaluation and to a wrong entry, as ``tests/test_torch_lm_kernels.py``
holds the forward kernels' bounds.  The same numpy inputs go to both
packages; shapes are small (T = 37, not a multiple of the kernels' tiles).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import _naive_attention  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

B, T, HD = 2, 37, 16
# (dtype, H, Hkv): f32 and f64 with a head per kv head, and a GQA group.
CASES = [("float32", 4, 4), ("float64", 4, 4), ("float32", 6, 2)]


def _operands(dtype, H, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, h, HD)).astype(dtype)
                 for h in (H, Hkv, Hkv, H))          # q, k, v, dout


def _reference(q, k, v):
    """The reference's attention on the port's layout: q (B, T, H, hd) to
    its (B, T, Hkv, g, hd) groups, out back to (B, T, H, hd)."""
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, q.shape[2] // Hkv, HD)
    pos = jnp.broadcast_to(jnp.arange(T), (B, T))
    return _naive_attention(qg, k, v, pos, HD).reshape(q.shape)


def _reference_lse(q, k):
    """logsumexp of the reference's masked scores, (B, H, T), in base 2."""
    Hkv = k.shape[2]
    qg = jnp.asarray(q).reshape(B, T, Hkv, q.shape[2] // Hkv, HD)
    logits = jnp.einsum("btkgh,bskh->bkgts", qg, jnp.asarray(k)) / math.sqrt(
        HD)
    mask = jnp.tril(jnp.ones((T, T), dtype=bool))
    lse = jax.nn.logsumexp(jnp.where(mask, logits, -1e30), axis=-1)
    return np.asarray(lse.reshape(B, -1, T)) / math.log(2.0)


# Tolerances: f32 sums of T and hd terms and the exp/log: a few hundred
# float32 eps of the row's scale; f64 the same in float32 (the plain
# version computes in float32 whatever the operands' type).
LSE_TOL = 1e-5
GRAD_TOL = 2e-5


@pytest.mark.parametrize("dtype,H,Hkv", CASES)
def test_plain_lse_matches_reference_logsumexp(dtype, H, Hkv):
    """``flash_attention_lse_ref`` is the reference's causal log-sum-exp
    times log2(e), within 1e-5 of the rows' largest magnitude."""
    q, k, _, _ = _operands(dtype, H, Hkv)
    got = fref.flash_attention_lse_ref(torch.from_numpy(q),
                                       torch.from_numpy(k)).numpy()
    want = _reference_lse(q, k)
    assert got.shape == (B, H, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LSE_TOL * np.abs(want).max())


@pytest.mark.parametrize("dtype,H,Hkv", CASES)
def test_bwd_given_lse_matches_recompute_and_reference_grad(dtype, H, Hkv):
    """The plain backward given that log-sum-exp equals the one that
    recomputes it, and both equal ``jax.grad`` of the reference's
    attention, within 2e-5 of each gradient's largest magnitude; the CPU
    wrapper passes the log-sum-exp through."""
    q, k, v, dout = _operands(dtype, H, Hkv, seed=1)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = fref.flash_attention_ref(tq, tk, tv)
    lse = fref.flash_attention_lse_ref(tq, tk)
    given = fref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse)
    recomputed = fref.flash_attention_bwd_ref(tq, tk, tv, out, tdo)

    def loss(q, k, v):
        return jnp.sum(_reference(q, k, v) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, r, w in zip(given, recomputed, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale)
    via_op = fops.attention_backward(tq, tk, tv, out, tdo, lse)
    assert all(torch.equal(a, b) for a, b in zip(via_op, given))


def _bwd_case():
    return checks.flash_attention_bwd_case(B, T, 4, 2, 48, torch.bfloat16,
                                           "cpu", seed=5)


def _bwd_f64(q, k, v, out, dout, lse=None):
    """The backward evaluated in float64 throughout (its own softmax, no
    rounding of P or dS), rounded to the operands' types at the end: a
    more accurate evaluation than the plain version's."""
    H, hd = q.shape[2:]
    Hkv = k.shape[2]
    g = H // Hkv
    qd, od, dod = q.double(), out.double(), dout.double()
    kd, vd = (x.double().repeat_interleave(g, dim=2) for x in (k, v))
    s = torch.einsum("bthd,bshd->bhts", qd, kd) / math.sqrt(hd)
    p = torch.softmax(torch.where(torch.ones(T, T, dtype=torch.bool).tril(),
                                  s, -torch.inf), -1)
    dp = torch.einsum("bthd,bshd->bhts", dod, vd)
    ds = p * (dp - (dod * od).sum(-1).permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, kd) / math.sqrt(hd)
    dk = torch.einsum("bhts,bthd->bshd", ds, qd) / math.sqrt(hd)
    dv = torch.einsum("bhts,bthd->bshd", p, dod)
    dk, dv = (x.reshape(B, T, Hkv, g, hd).sum(3) for x in (dk, dv))
    return tuple(x.to(y.dtype) for x, y in zip((dq, dk, dv), (q, k, v)))


def test_bf16_bwd_bound_passes_a_more_accurate_evaluation(monkeypatch):
    monkeypatch.setattr(fops, "attention_backward", _bwd_f64)
    res = checks.compare(_bwd_case())
    assert 0.0 < res["max_abs_err"] and res["max_err_over_tol"] <= 1.0


@pytest.mark.parametrize("output", [0, 1, 2])
def test_bf16_bwd_bound_refuses_a_wrong_entry(output):
    """dq, dk or dv with one entry 25 % off (a bf16 ulp is 0.8 %): the
    last query row of dq (its longest sum), the first key's rows of dk and
    dv (theirs)."""
    case = _bwd_case()
    checks.compare(case)

    def kernel():
        grads = [g.clone() for g in case.kernel()]
        at = (0, -1) if output == 0 else (0, 0)
        grads[output][at] *= 1.25
        return tuple(grads)

    with pytest.raises(AssertionError, match="exceeds its bound"):
        checks.compare(dataclasses.replace(case, kernel=kernel))
