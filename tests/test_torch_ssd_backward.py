"""The backward of the SSD intra-chunk term on the CPU.

``ssd_chunk.ref.ssd_intra_chunk_bwd_ref`` (the plain version of
``csrc/ssd_intra_chunk_bwd.cu``) against ``jax.vjp`` of the reference's
``repro.kernels.ssd_chunk.ref.ssd_intra_chunk_ref`` on the same numpy
inputs, and against autograd of the port's plain forward; a Mamba block's
input and parameter gradients against ``jax.grad`` of the reference's
``mamba_apply``; and the per-entry bound ``kernels.checks`` holds the CUDA
kernel to.

Tolerances, relative to each output's largest magnitude: float64 1e-12
and float32 1e-5 (both sides sum the same terms in other orders, at most
64 of them a sum); the Mamba block 1e-4 (the reference's bar between its
naive and flash attention, carried through the backward, as in
``test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.ssd_chunk.ref import \
    ssd_intra_chunk_ref as j_ssd_ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import (  # noqa: E402
    ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref)
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

RTOL = {"float64": 1e-12, "float32": 1e-5}
GRAD_RTOL = 1e-4
NAMES = ("dc", "db", "dx", "dcum")

# (G, Q, N, H, P, decay per step).  The last is a steep decay: cum falls
# by up to 5 a step, so the far entries' decays reach e^-75 (near float32's
# smallest normal); its 16 steps keep exp(cum_t - cum_s) above the
# diagonal below float32's overflow, which the reference's jnp oracle
# evaluates before its mask (its vjp multiplies the masked zeros by that
# exponential).
SHAPES = {"2x8": (2, 8, 8, 4, 16, 0.2), "3x16": (3, 16, 8, 2, 16, 0.2),
          "1x64": (1, 64, 16, 3, 8, 0.2), "steep": (2, 16, 8, 3, 8, 5.0)}


def _inputs(G, Q, N, H, P, decay, seed):
    """c, b (G, Q, N) of spread 0.3, x and dy (G, Q, H, P) standard
    normal, cum (G, Q, H) falling by uniform(0, decay) a step; float64
    numpy."""
    rng = np.random.default_rng(seed)
    c, b = (rng.normal(size=(G, Q, N)) * 0.3 for _ in range(2))
    x = rng.normal(size=(G, Q, H, P))
    cum = -np.cumsum(rng.uniform(0, decay, (G, Q, H)), axis=1)
    dy = rng.normal(size=(G, Q, H, P))
    return c, b, x, cum, dy


def _rel_err(got, want) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_matches_reference_vjp(shape, dtype):
    """(dc, db, dx, dcum) against ``jax.vjp`` of the reference's
    intra-chunk term, cum in the operands' type."""
    *dims, decay = SHAPES[shape]
    arrays = [a.astype(dtype) for a in _inputs(*dims, decay, seed=sum(dims))]
    _, vjp = jax.vjp(j_ssd_ref, *(jnp.asarray(a) for a in arrays[:4]))
    want = vjp(jnp.asarray(arrays[4]))
    got = ssd_intra_chunk_bwd_ref(*(torch.from_numpy(a) for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
        assert _rel_err(g, w) <= RTOL[dtype], (name, _rel_err(g, w))


@pytest.mark.parametrize("decay", [0.2, 200.0])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_plain_backward_equals_autograd_of_plain_forward(dtype, decay):
    """The explicit formulas against ``torch.autograd`` of
    ``ssd_intra_chunk_ref``.  At a decay of 200 a step exp(cum_t - cum_s)
    overflows above the diagonal in every type and underflows below it:
    both stay finite (the exponent is selected before the exponential).
    float64 at 1e-12 and float32 at 1e-5 of each output's largest entry;
    bfloat16 rounds m, dM, dc, db and dx to the type at the same points as
    autograd does, so an entry may differ only where a float32 sum taken
    in another order lands on the other side of a bfloat16 rounding: by
    one bfloat16 step of the entry (2^-7 of it), plus 1e-5 of the
    output's largest entry for dcum's float32 sums."""
    t = getattr(torch, dtype)
    ct = torch.float64 if dtype == "float64" else torch.float32
    c, b, x, cum, dy = _inputs(2, 16, 8, 3, 8, decay, seed=3)
    ops = [torch.from_numpy(a).to(t).requires_grad_() for a in (c, b, x)]
    tcum = torch.from_numpy(cum).to(ct).requires_grad_()
    tdy = torch.from_numpy(dy).to(t)
    y = ssd_intra_chunk_ref(*ops, tcum)
    want = torch.autograd.grad(y, (*ops, tcum), tdy)
    got = ssd_intra_chunk_bwd_ref(*(v.detach() for v in ops), tcum.detach(),
                                  tdy)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all(), name
        if dtype == "bfloat16":
            gap = (g.double() - w.double()).abs()
            bar = (2.0 ** -7 * w.double().abs()
                   + 1e-5 * float(w.double().abs().max()))
            assert bool((gap <= bar).all()), name
        else:
            assert _rel_err(g, w.detach().double().numpy()) <= RTOL[dtype], \
                name


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors ``intra_chunk`` is the plain forward (autograd
    differentiates it) and ``intra_chunk_backward`` the plain backward,
    taking a dy of another type or layout as the kernel's binding does
    (cast to x's type, made contiguous)."""
    c, b, x, cum, dy = (torch.from_numpy(a).float()
                        for a in _inputs(2, 16, 8, 3, 8, 0.2, seed=4))
    ops = [v.to(torch.bfloat16).requires_grad_() for v in (c, b, x)]
    y = sops.intra_chunk(*ops, cum.requires_grad_())
    dy_t = dy.transpose(1, 2).contiguous().transpose(1, 2)   # not contiguous
    assert not dy_t.is_contiguous()
    grads = torch.autograd.grad(y, (*ops, cum), dy_t.to(torch.bfloat16))
    got = sops.intra_chunk_backward(*(v.detach() for v in ops),
                                    cum.detach(), dy_t)
    for g, w in zip(got, grads):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert got[3].dtype == torch.float32
    want = ssd_intra_chunk_bwd_ref(*(v.detach() for v in ops), cum.detach(),
                                   dy.to(torch.bfloat16))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def mamba_grads():
    """A Mamba block at smoke widths (d 64, N 8, 8 heads of 16, chunk 8)
    over T = 32 (four chunks), float32: the reference's weights from its
    ``init_params`` carried into the port by ``lm_params_from_numpy``;
    the gradients of Σ y∘w for a fixed w, in both packages."""
    jcfg = dataclasses.replace(j_get_config("jamba_1_5_large_398b",
                                            smoke=True),
                               block_pattern=("mamba",), n_layers=1,
                               moe=None)
    tcfg = dataclasses.replace(get_config("jamba_1_5_large_398b",
                                          smoke=True),
                               block_pattern=("mamba",), n_layers=1,
                               moe=None)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    tree = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree),
                                         tcfg, "cpu", requires_grad=True)
    jp = jax.tree.map(lambda a: a[0], tree["slots"]["slot0"]["mixer"])
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 4 * tcfg.ssm_chunk, tcfg.d_model)).astype(
        np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def j_loss(p, xx):
        return jnp.sum(jssm.mamba_apply(p, jcfg, xx) * w)

    jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp,
                                                            jnp.asarray(x))
    mixer = model.layers[0].mixer
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tssm.mamba_apply(mixer, tcfg, tx) * torch.from_numpy(w)).sum()
    leaves = dict(mixer.named_parameters())
    tg = torch.autograd.grad(loss, [tx, *leaves.values()])
    want = {"x": np.asarray(jg_x), **dict(convert._leaves(
        jax.tree.map(np.asarray, jg_p)))}
    return want, {"x": tg[0], **dict(zip(leaves, tg[1:]))}


def test_mamba_block_gradients_match_reference(mamba_grads):
    """The block's input gradient and every parameter's (in_proj, conv_w,
    bc_proj, dt_proj, dt_bias, a_log, d_skip, out_norm, out_proj): the
    intra-chunk term's gradient reaches dt_proj, a_log and dt_bias through
    cum and x·dt, and c and b through bc_proj."""
    want, got = mamba_grads
    assert set(want) == set(got)
    for name, w in want.items():
        assert float(np.abs(w).max()) > 0, name
        assert _rel_err(got[name], w) <= GRAD_RTOL, (name,
                                                     _rel_err(got[name], w))


# --------------------------------------------------------------------------
# The per-entry bound the CUDA kernel is held to (``checks``).

BOUND_SHAPE = (2, 100, 33, 5, 24)      # Q off the 64-row tile, N off 64


def _accurate(case_args):
    """The backward in float64 throughout (no rounding of m or dM), each
    output rounded to its type at the end: a more accurate evaluation than
    the plain version's."""
    c, b, x, cum, dy = case_args
    out = ssd_intra_chunk_bwd_ref(c.double(), b.double(), x.double(),
                                  cum.double(), dy.double())
    return tuple(o.to(r.dtype) for o, r in zip(out, (c, b, x, cum)))


@pytest.mark.parametrize("decay", [0.2, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_bound_passes_a_more_accurate_evaluation(dtype, decay):
    """At a decay of 1.0 a step the far entries' decays fall below
    float32's normal range."""
    case = checks.ssd_intra_chunk_bwd_case(*BOUND_SHAPE, dtype, "cpu",
                                           seed=5, decay=decay)
    exact = _accurate(checks.ssd_operands(*BOUND_SHAPE, dtype, "cpu", seed=5,
                                          decay=decay, with_dy=True))
    res = checks.compare(dataclasses.replace(case, kernel=lambda: exact))
    assert 0.0 < res["max_abs_err"] and res["max_err_over_tol"] <= 1.0


@pytest.mark.parametrize("k", range(4), ids=NAMES)
@pytest.mark.parametrize("dtype,factor", [(torch.float32, 1 + 1e-3),
                                          (torch.bfloat16, 1 + 6e-2)])
def test_bwd_bound_refuses_a_wrong_entry(dtype, factor, k):
    """Each output's largest entry off by 0.1 % (float32) or 6 % (bf16,
    four of its rounding steps) is refused."""
    case = checks.ssd_intra_chunk_bwd_case(*BOUND_SHAPE, dtype, "cpu",
                                           seed=5)
    checks.compare(case)

    def kernel():
        outs = [o.clone().contiguous() for o in case.kernel()]
        flat = outs[k].view(-1)
        i = int(flat.float().abs().argmax())
        flat[i] = flat[i] * factor
        return tuple(outs)

    with pytest.raises(AssertionError, match=f"output {k} .*exceeds"):
        checks.compare(dataclasses.replace(case, kernel=kernel))


def test_bwd_bound_at_jambas_shape():
    """Jamba's training shape (16 chunks of 256, N = 128, 256 heads of 64,
    bf16): c, b, x, dy and cum read, dc, db, dx and dcum written: 415 MB,
    0.124 ms at 3.35 TB/s, beside 3.6e10 flops for the causal half (0.036
    ms at 989 TFLOP/s): bytes bound it."""
    nbytes, flops = checks.ssd_intra_chunk_bwd_work(16, 256, 128, 256, 64, 2)
    assert nbytes == pytest.approx(415.2e6, rel=1e-3)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.124, rel=1e-2)
    assert flops == 16 * 256 * 257 / 2 * (6 * 128 + 256 * (4 * 64 + 8))
    assert flops / 989e12 < nbytes / 3.35e12
