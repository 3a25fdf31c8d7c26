"""Plain PyTorch versions of the LM kernels (``flash_attention``,
``ssd_intra_chunk``) against the reference's interpret-mode Pallas kernels
and ``ref.py`` oracles, on the same numpy inputs, through the port's
wrappers (on the CPU the wrapper is the plain version).

Shapes are ``tests/test_kernels_pallas.py``'s.  float32 at 1e-5: both
sides sum in float32, in different orders over at most 128 terms.
bfloat16 at the reference's 3e-2: both round p (or m) and the output to
bfloat16, at different places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.flash_attn import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attn.ref import \
    flash_attention_ref as j_flash_ref  # noqa: E402
from repro.kernels.ssd_chunk.ref import \
    ssd_intra_chunk_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_chunk.ssd_chunk import \
    ssd_intra_chunk as j_ssd  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as sops  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

TYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
         "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a32: np.ndarray, dtype: str):
    """The same float32 numpy values as a JAX and a torch array of the
    type (each rounds float32 to bfloat16 to nearest even)."""
    jt, tt, _ = TYPES[dtype]
    return jnp.asarray(a32, jt), torch.from_numpy(a32).to(tt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("BH,T,hd", [(2, 64, 32), (3, 128, 64), (1, 64, 100)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_plain_matches_reference(BH, T, hd, dtype):
    rng = np.random.default_rng(BH * T + hd)
    q32, k32 = (rng.normal(size=(BH, T, hd)).astype(np.float32) * 0.5
                for _ in range(2))
    v32 = rng.normal(size=(BH, T, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q32, k32, v32))
    # The port's layout (B, T, H, hd) with one head per batch row.
    got = fops.causal_attention(tq[:, :, None], tk[:, :, None],
                                tv[:, :, None])[:, :, 0]
    assert got.dtype == TYPES[dtype][1] and got.shape == (BH, T, hd)
    tol = TYPES[dtype][2]
    _close(got, j_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True),
           tol)
    _close(got, j_flash_ref(jq, jk, jv), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_gqa_head_mapping(dtype):
    """q head h reads kv head h // (H / Hkv): the reference's jnp.repeat of
    k and v over the heads, then (BH, T, hd) slices."""
    B, T, H, Hkv, hd = 2, 48, 6, 2, 16
    rng = np.random.default_rng(7)
    q32 = rng.normal(size=(B, T, H, hd)).astype(np.float32) * 0.5
    k32 = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32) * 0.5
    v32 = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q32, k32, v32))
    got = fops.causal_attention(tq, tk, tv)

    def heads(x):                  # (B, T, H, hd) -> (B·H, T, hd)
        return jnp.moveaxis(x, 2, 1).reshape(B * H, T, hd)

    want = j_flash_ref(heads(jq), heads(jnp.repeat(jk, H // Hkv, axis=2)),
                       heads(jnp.repeat(jv, H // Hkv, axis=2)))
    want = np.moveaxis(_np(want).reshape(B, H, T, hd), 1, 2)
    _close(got, want, TYPES[dtype][2])
    # The same as the port's own plain version on k and v repeated.
    rep = fops.causal_attention(tq, tk.repeat_interleave(H // Hkv, dim=2),
                                tv.repeat_interleave(H // Hkv, dim=2))
    assert torch.equal(got, rep)


def test_flash_attention_causality():
    """A change to the last key and value leaves every earlier output as it
    was."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 2, 32))).float()
               for _ in range(3))
    o1 = fops.causal_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 10.0
    v2[:, -1] += 10.0
    o2 = fops.causal_attention(q, k2, v2)
    assert torch.equal(o1[:, :-1], o2[:, :-1])
    assert not torch.equal(o1[:, -1], o2[:, -1])


@pytest.mark.parametrize("hd", [32, 64, 100, 128])
def test_flash_attention_head_dim_padding(hd):
    """The bfloat16 kernel reads q, k and v with the head dim zero-padded
    to 64 or 128 (its TMA boxes) and scales by 1/sqrt(true hd): attention
    over the padded operands at that scale is attention over the originals
    in the first hd columns and exact zeros past them.  Evaluated in
    float64 against the plain version (float32 sums: 1e-5)."""
    hdp = fops.tma_head_dim(hd)
    assert hdp == (64 if hd <= 64 else 128)
    rng = np.random.default_rng(hd)
    B, T, H, Hkv = 2, 40, 4, 2
    q = torch.from_numpy(rng.normal(size=(B, T, H, hd)))
    k, v = (torch.from_numpy(rng.normal(size=(B, T, Hkv, hd)))
            for _ in range(2))
    qp, kp, vp = (fops.pad_head_dim(x, hdp) for x in (q, k, v))
    assert qp.shape[-1] == hdp and (qp is q) == (hd == hdp)
    kp, vp = (x.repeat_interleave(H // Hkv, dim=2) for x in (kp, vp))
    s = torch.einsum("bthd,bshd->bhts", qp, kp) / hd ** 0.5
    causal = torch.ones((T, T), dtype=torch.bool).tril()
    p = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, vp)
    np.testing.assert_allclose(out[..., :hd].numpy(),
                               fops.causal_attention(q, k, v).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not out[..., hd:].any()


def _ssd_inputs(G, Q, N, H, P, seed):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(G, Q, N)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(G, Q, N)) * 0.3).astype(np.float32)
    x = rng.normal(size=(G, Q, H, P)).astype(np.float32)
    cum = -np.abs(np.cumsum(rng.uniform(0, 0.2, (G, Q, H)),
                            axis=1)).astype(np.float32)
    return c, b, x, cum


@pytest.mark.parametrize("G,Q,N,H,P", [(2, 16, 8, 2, 16), (3, 32, 16, 4, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_intra_chunk_plain_matches_reference(G, Q, N, H, P, dtype):
    c, b, x, cum = _ssd_inputs(G, Q, N, H, P, seed=G * Q + H)
    (jc, tc), (jb, tb), (jx, tx) = (_both(a, dtype) for a in (c, b, x))
    got = sops.intra_chunk(tc, tb, tx, torch.from_numpy(cum))
    assert got.dtype == TYPES[dtype][1] and got.shape == (G, Q, H, P)
    tol = TYPES[dtype][2]
    jcum = jnp.asarray(cum)
    _close(got, j_ssd(jc, jb, jx, jcum, interpret=True), tol)
    _close(got, j_ssd_ref(jc, jb, jx, jcum), tol)


@pytest.mark.parametrize("N,P", [(8, 16), (33, 63), (64, 8), (128, 64)])
def test_ssd_intra_chunk_tma_padding(N, P):
    """The bfloat16 kernel reads c and b with N zero-padded to 64 or 128
    and x with P zero-padded to 64 (its TMA boxes): the term over the
    padded operands is the term over the originals in the first P columns
    and exact zeros past them.  Through the plain version with float64
    operands (its float32 scores only gain zero terms: 1e-12)."""
    Np = sops.tma_state_dim(N)
    assert Np == (64 if N <= 64 else 128)
    c, b, x, cum = (torch.from_numpy(a).double()
                    for a in _ssd_inputs(2, 40, N, 3, P, seed=N + P))
    cp, bp = sops.pad_last(c, Np), sops.pad_last(b, Np)
    xp = sops.pad_last(x, sops.TMA_BOX)
    assert (cp.shape[-1], xp.shape[-1]) == (Np, 64)
    assert (cp is c) == (N == Np) and (xp is x) == (P == 64)
    out = sops.intra_chunk(cp, bp, xp, cum.float())
    np.testing.assert_allclose(out[..., :P].numpy(),
                               sops.intra_chunk(c, b, x, cum.float()).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert not out[..., P:].any()


def test_ssd_intra_chunk_bf16_state_limit():
    """States wider than two TMA boxes are refused, not truncated."""
    with pytest.raises(ValueError, match="state"):
        sops.tma_state_dim(sops.MAX_STATE_BF16 + 1)


def test_ssd_intra_chunk_causality_and_no_overflow():
    """A change to the last input leaves earlier outputs as they were; a
    steep decay (exp(cum_t - cum_s) overflows float32 for s > t) gives
    finite outputs: the exponent is selected away before the exp."""
    c, b, x, cum = _ssd_inputs(1, 16, 8, 2, 8, seed=11)
    args = [torch.from_numpy(a) for a in (c, b, x)]
    steep = torch.from_numpy(cum) * 1000.0          # cum down to ~ -1600
    o1 = sops.intra_chunk(*args, steep)
    assert torch.isfinite(o1).all()
    x2 = args[2].clone()
    x2[:, -1] += 5.0
    o2 = sops.intra_chunk(args[0], args[1], x2, steep)
    assert torch.equal(o1[:, :-1], o2[:, :-1])
    assert not torch.equal(o1[:, -1], o2[:, -1])


# --------------------------------------------------------------------------
# The per-entry bounds ``kernels.checks`` holds the two CUDA kernels to.

from repro_torch.kernels import checks  # noqa: E402

SHAPES = {"flash_attention": (2, 100, 4, 2, 48),     # B, T, H, Hkv, hd
          "ssd_intra_chunk": (3, 40, 16, 5, 8)}      # G, Q, N, H, P


def _lm_case(name, dtype):
    make = (checks.flash_attention_case if name == "flash_attention"
            else checks.ssd_intra_chunk_case)
    return make(*SHAPES[name], dtype, "cpu", seed=5)


def _attention_f64(q, k, v):
    """Causal attention evaluated in float64 throughout (no rounding of p),
    rounded to q's type at the end: a more accurate evaluation than the
    plain version's."""
    B, T, H, hd = q.shape
    g = H // k.shape[2]
    kk = k.double().repeat_interleave(g, dim=2)
    vv = v.double().repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.double(), kk) / hd ** 0.5
    s = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), s,
                    -torch.inf)
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1),
                        vv).to(q.dtype)


def _ssd_f64(c, b, x, cum):
    """The intra-chunk term in float64 throughout (no rounding of m),
    rounded to x's type at the end."""
    Q = c.shape[1]
    scores = torch.einsum("gqn,gsn->gqs", c.double(), b.double())
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, :, :, None]
    ld = cum.double()[:, :, None, :] - cum.double()[:, None, :, :]
    m = scores[..., None] * torch.where(
        causal, torch.exp(torch.where(causal, ld, 0.0)), 0.0)
    return torch.einsum("gqsh,gshp->gqhp", m, x.double()).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SHAPES))
def test_lm_kernel_bounds_pass_a_more_accurate_evaluation(monkeypatch, name,
                                                          dtype):
    monkeypatch.setattr(fops, "causal_attention", _attention_f64)
    monkeypatch.setattr(sops, "intra_chunk", _ssd_f64)
    res = checks.compare(_lm_case(name, dtype))
    assert 0.0 < res["max_abs_err"] and res["max_err_over_tol"] <= 1.0


@pytest.mark.parametrize("dtype,factor", [(torch.float32, 1 + 1e-3),
                                          (torch.bfloat16, 1 + 6e-2)])
@pytest.mark.parametrize("name", list(SHAPES))
def test_lm_kernel_bounds_refuse_a_wrong_entry(name, dtype, factor):
    import dataclasses

    case = _lm_case(name, dtype)
    checks.compare(case)

    def kernel():
        (out,) = case.kernel()
        out = out.clone()
        out[0, -1] *= factor          # the last row: the longest sum
        return (out,)

    with pytest.raises(AssertionError, match="exceeds its bound"):
        checks.compare(dataclasses.replace(case, kernel=kernel))


def test_lm_kernel_bounds_at_the_prefill_shape():
    """Jamba's prefill (B = 1, T = 4096, bf16): attention 2.75e11 flops
    (0.278 ms at 989 TFLOP/s) beside 151 MB (0.045 ms at 3.35 TB/s); the
    intra-chunk term of 16 chunks of 256, N = 128, 256 heads of 64:
    275 MB (0.082 ms) beside 1.77e10 flops (0.018 ms)."""
    fb, ff = checks.flash_attention_work(1, 4096, 64, 8, 128, 2)
    assert ff == pytest.approx(2.75e11, rel=2e-3)
    assert fb == pytest.approx(151e6, rel=1e-2)
    assert ff / 989e12 * 1e3 == pytest.approx(0.278, rel=2e-3)
    sb, sf = checks.ssd_intra_chunk_work(16, 256, 128, 256, 64, 2)
    assert sb == pytest.approx(275e6, rel=1e-2)
    assert sb / 3.35e12 * 1e3 == pytest.approx(0.082, rel=1e-2)
    assert sf == pytest.approx(1.77e10, rel=1e-2)
