"""The port's optimizers, schedules and gradient compression
(``repro_torch.optim``) against the reference's (``repro.optim``), fed the
same numpy trees.

Tolerances: the schedules agree to 1e-6 relative (the reference computes
in float32, the port in Python floats).  The optimizers run both sides in
float32, the same formula leaf by leaf; the port's bias corrections are
Python floats where the reference rounds b^t to float32, so the updated
parameters and moments agree to 2e-6 relative to each leaf's largest
magnitude (a few float32 roundings of the update).  Compression is held
exactly where the arithmetic is the same (the int8 payload, the scales,
the round trip), and the mean over ranks to 1e-6 of its scale (float32
sums in the same rank order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsch  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsch  # noqa: E402
from repro_torch.testing import spmd  # noqa: E402

OPT_RTOL = 2e-6


def _close(got, want, rtol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("kind", ["constant", "cosine", "wsd"])
def test_schedules_match_reference(kind):
    """Every step of 0..total (and past it) for each kind, with warmup and
    decay inside the run; linear_warmup alongside."""
    cfg = dict(kind=kind, lr=3e-4, warmup=7, total=40, decay_frac=0.25,
               floor=0.1)
    got = tsch.make_schedule(tsch.ScheduleConfig(**cfg))
    steps = jnp.arange(46, dtype=jnp.int32)     # elementwise in the reference
    want = np.broadcast_to(np.asarray(jsch.make_schedule(
        jsch.ScheduleConfig(**cfg))(steps)), steps.shape)   # constant: 0-d
    warm = np.asarray(jsch.linear_warmup(1e-3, 5)(steps))
    warm_t = tsch.linear_warmup(1e-3, 5)
    for step in range(46):
        assert abs(got(step) - want[step]) <= 1e-6 * 3e-4, (step, got(step))
        assert got(torch.tensor(step, dtype=torch.int32)) == got(step)
        assert abs(warm_t(step) - warm[step]) <= 1e-9


def _tree(seed):
    """A parameter tree with a matrix, a 3-d expert bank, a vector (no
    decay, unfactored) and a 1 x n matrix (unfactored in adafactor)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "experts": (3, 4, 6), "bias": (7,),
              "row": (1, 9)}
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def _to_torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _states_close(got, want):
    """The port's state (flat dicts) against the reference's."""
    if isinstance(want, dict):
        for k in want:
            _states_close(got[k], want[k])
    else:
        _close(got, np.asarray(want), OPT_RTOL)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
@pytest.mark.parametrize("n_updates", [1, 3])
def test_optimizer_updates_match_reference(name, n_updates):
    """One and three updates from the same tree and gradients; the vector
    leaf takes no weight decay (adamw: decoupled decay on ndim >= 2 only).
    Adafactor runs with weight decay 0.1 so its matrices decay too."""
    kw = {"adafactor": {"weight_decay": 0.1}}.get(name, {})
    jo, to = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    params = _tree(0)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for i in range(n_updates):
        grads = _tree(10 + i)
        lr = 1e-2 * (i + 1)
        jp, js = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                         js, jp, lr)
        tp, ts = to.update(_to_torch(grads), ts, tp, lr)
    assert int(ts.step) == int(js.step) == n_updates
    assert ts.step.dtype == torch.int32
    for k in params:
        _close(tp[k], jp[k], OPT_RTOL)
        assert tp[k].dtype == torch.float32
    _states_close(ts.inner, jax.tree.map(np.asarray, js.inner))
    if name == "adamw":
        # The vector took no decay: with zero gradients and a fresh state
        # a matrix shrinks by lr * wd, the vector does not move.
        zero = {k: torch.zeros_like(v) for k, v in _to_torch(params).items()}
        p0 = _to_torch(params)
        to.update(zero, to.init(p0), p0, 0.5)
        assert torch.equal(p0["bias"], torch.tensor(params["bias"]))
        np.testing.assert_allclose(p0["w"].numpy(), params["w"] * 0.95,
                                   rtol=1e-6)


def test_adamw_keeps_float32_moments_for_bfloat16_parameters():
    """A bf16 parameter keeps its type; its moments are float32; the update
    is the float32 one rounded once to bf16."""
    p = {"w": torch.tensor(_tree(0)["w"]).bfloat16()}
    g = {"w": torch.tensor(_tree(1)["w"]).bfloat16()}
    opt = topt.adamw()
    st = opt.init(p)
    want = p["w"].float().clone()
    gf = g["w"].float()
    u = gf / (gf.abs() + 1e-8) + 0.1 * want
    opt.update(g, st, p, 1e-2)
    assert p["w"].dtype == torch.bfloat16
    assert st.inner["mu"]["w"].dtype == torch.float32
    assert torch.equal(p["w"], (want - 1e-2 * u).bfloat16())


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3)
    want, wnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    got, norm = topt.clip_by_global_norm(_to_torch(grads), max_norm)
    _close(norm, np.asarray(wnorm), 1e-6)
    for k in grads:
        _close(got[k], np.asarray(want[k]), 1e-6)
    bf = {"g": torch.tensor(grads["w"]).bfloat16()}
    assert topt.clip_by_global_norm(bf, 0.5)[0]["g"].dtype == torch.bfloat16


def test_int8_round_trip_matches_reference():
    """Blocks of 256 (a ragged last block), the payload and the scales bit
    for bit, the round trip within half a step of each block's scale."""
    g = np.random.default_rng(5).normal(size=(7, 83)).astype(np.float32)
    g[2, :10] = 0.0
    jq, js = jcomp.compress_int8(jnp.asarray(g))
    tq, ts = tcomp.compress_int8(torch.tensor(g))
    assert tq.dtype == torch.int8 and tq.shape == (3, 256)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    back = tcomp.decompress_int8(tq, ts, g.shape, g.size)
    want = jcomp.decompress_int8(jq, js, g.shape, g.size)
    assert np.array_equal(back.numpy(), np.asarray(want))
    step = np.repeat(ts.numpy(), 256)[:g.size].reshape(g.shape)
    assert (np.abs(back.numpy() - g) <= 0.5 * step + 1e-12).all()


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(5, 130)) * scale).astype(np.float32),
            "b": (rng.normal(size=(9,)) * scale).astype(np.float32)}


def test_error_feedback_matches_reference_on_one_rank():
    """The reference's npods=1 case (an all-gather over a vmapped axis of
    one) against the port without a process group, over four steps: the
    means and the carried residuals."""
    jstate = jcomp.init_state({k: jnp.asarray(v)
                               for k, v in _grads(0).items()})
    tstate = tcomp.init_state(_to_torch(_grads(0)))

    def jstep(g, st):
        return jcomp.compressed_psum(g, st, "pod", npods=1)

    # Eager, not jitted: XLA's fusions may round g/scale apart from the
    # plain division at a half-step tie, and the residual by one step.
    jfn = jax.vmap(jstep, axis_name="pod")
    for i in range(4):
        g = _grads(20 + i, scale=1.0 + i)
        jmean, jstate1 = jfn(
            {k: jnp.asarray(v)[None] for k, v in g.items()},
            jax.tree.map(lambda e: e[None], jstate))
        jstate = jax.tree.map(lambda e: e[0], jstate1)
        tmean, tstate = tcomp.compressed_psum(_to_torch(g), tstate)
        for k in g:
            _close(tmean[k], np.asarray(jmean[k][0]), 1e-6)
            _close(tstate.error[k], np.asarray(jstate.error[k]), 1e-6)
            # The residual is what the int8 payload did not carry.
            assert float(tstate.error[k].abs().max()) > 0


def test_compressed_psum_on_two_gloo_ranks(tmp_path):
    """Two ranks of ``testing/spmd`` over gloo, three steps with error
    feedback: each step's mean is the mean of the two ranks' dequantised
    payloads (computed here from each rank's own targets), the same on
    both ranks, and equal to the reference's all-gather over a vmapped
    pod axis of two."""
    steps = [[_to_torch(_grads(100 * s + r, scale=1.0 + r))
              for r in range(2)] for s in range(3)]
    outs = spmd.launch(2, [{"kind": "compressed_psum", "grads": steps}],
                       workdir=tmp_path, timeout=120)
    assert not any(o["reference_loaded"] for o in outs)
    r0, r1 = (o["outs"][0] for o in outs)
    errs = [tcomp.init_state(steps[0][r]).error for r in range(2)]
    jfn = jax.vmap(lambda g, st: jcomp.compressed_psum(g, st, "pod",
                                                       npods=2),
                   axis_name="pod")
    jstate = jcomp.CompressionState(error={
        k: jnp.zeros((2,) + tuple(v.shape), jnp.float32)
        for k, v in steps[0][0].items()})
    for s, per_rank in enumerate(steps):
        jmean, jstate = jfn({k: jnp.stack([jnp.asarray(per_rank[r][k].numpy())
                                           for r in range(2)])
                             for k in per_rank[0]}, jstate)
        for k in per_rank[0]:
            deq = []
            for r in range(2):
                target = per_rank[r][k].float() + errs[r][k]
                q, sc = tcomp.compress_int8(target)
                deq.append(tcomp.decompress_int8(q, sc, target.shape,
                                                 target.numel()))
                errs[r][k] = target - deq[-1]
            want = (deq[0] + deq[1]) / 2
            assert torch.equal(r0["means"][s][k], r1["means"][s][k])
            _close(r0["means"][s][k], want.numpy(), 1e-6)
            _close(r0["means"][s][k], np.asarray(jmean[k][0]), 1e-6)
    for k in errs[0]:
        _close(r0["error"][k], errs[0][k].numpy(), 1e-6)
        _close(r1["error"][k], errs[1][k].numpy(), 1e-6)


def test_reference_decays_stacked_norm_scales_the_port_does_not():
    """Witness of a reference fault (ROADMAP.md §3): the reference stacks
    each layer's parameters over periods, so a per-layer vector (an RMSNorm
    scale, (d,)) is a (periods, d) matrix to its AdamW and takes the
    weight decay meant for matrices; the port's tree is per layer, and the
    vector takes none.  With zero gradients from a fresh state the
    reference shrinks the stacked scales by lr·wd, the port leaves them.
    This fails once the reference decays by the per-layer rank."""
    scales = np.ones((3, 8), np.float32)          # 3 periods of a (8,) scale
    jp = {"slots": {"slot0": {"norm1": {"scale": jnp.asarray(scales)}}}}
    jz = jax.tree.map(jnp.zeros_like, jp)
    jo = jopt.adamw()
    jp, _ = jo.update(jz, jo.init(jp), jp, 0.5)
    got = np.asarray(jp["slots"]["slot0"]["norm1"]["scale"])
    np.testing.assert_allclose(got, 0.95, rtol=1e-6)
    to = topt.adamw()
    tp = {f"layers.{i}.norm1.scale": torch.ones(8) for i in range(3)}
    to.update({k: torch.zeros(8) for k in tp}, to.init(tp), tp, 0.5)
    assert all(torch.equal(v, torch.ones(8)) for v in tp.values())
