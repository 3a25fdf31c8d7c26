"""Training in the port (``lm.loss_fn``, ``launch/steps.make_train_step``,
``launch/train``, the train-state carry-over) against the reference, at
smoke width in float32 on the same weights and the same numpy batches.

Tolerances.  The loss and accuracy agree to 1e-5 (float32 sums of a few
hundred terms in different orders); each gradient leaf to 1e-4 of its own
largest magnitude (the reference's bar between its naive and flash
attention, ``tests/test_models.py``, carried through the backward).  Two
train steps run momentum SGD, linear in the gradients, so the parameters
and momenta keep the gradients' bar (1e-4 of each leaf's largest
magnitude).  AdamW is held on flat trees (``test_torch_optim.py``): its
first steps move an entry by lr·g/(|g| + eps), so an entry whose gradient
sits at rounding level (4e-9 against a leaf's 0.5 here) moves by a
different fraction of lr in each package, far outside any relative bar of
the whole leaf.
``remat`` and resumed runs are held bit for bit.

Reference compiles: six in all (a ``value_and_grad`` of the loss for each
of four configs, and ``make_train_step`` at accum 1 and 2), each built
once in a module-scoped fixture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsch  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsch  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
B, T = 2, 16

DENSE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=128, dtype="float32")
# Four configs: MiniCPM's smoke (tied embeddings, residual scale), Jamba's
# (Mamba + MoE on the CPU twins) and xLSTM's, each of the last two cut to
# a period of two layers (a Mamba layer with a dense FFN and an attention
# layer with the experts; an mLSTM and an sLSTM layer): the reference's
# compile grows with the period, the layers' kinds are all kept.  And a
# dense one with Nyström attention over two chunks of 128 (so the
# landmarks carry gradient).
CONFIGS = {"minicpm": ("minicpm_2b", {}, T),
           "jamba": ("jamba_1_5_large_398b",
                     {"block_pattern": ("mamba", "attn"), "n_layers": 2}, T),
           "xlstm": ("xlstm_125m",
                     {"block_pattern": ("mlstm", "slstm"), "n_layers": 2}, T),
           "nystrom": (None, {"attention": "nystrom",
                              "nystrom_landmarks": 8}, 256)}


def _cfgs(name):
    arch, kw, seq = CONFIGS[name]
    if arch is None:
        return JArchConfig(**DENSE, **kw), ArchConfig(**DENSE, **kw), seq
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg, seq


def _batch(cfg, seq, seed=1, batch=B):
    """Tokens and next-token labels, the last position masked (-1)."""
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))
    labels = np.concatenate([tok[:, 1:], np.full((batch, 1), -1)], 1)
    return {"tokens": tok, "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def _rel_close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (what, err)


def _port_leaves_as_reference(tree: dict, cfg) -> dict:
    """The port's {name: tensor} as the reference's nested, stacked tree
    of numpy arrays."""
    nested = convert.lm_tree({k: v.detach() for k, v in tree.items()}, cfg)
    return jax.tree.map(lambda t: t.numpy(), nested)


def _tree_close(got: dict, want: dict, rtol, path=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _tree_close(got[k], w, rtol, f"{path}/{k}")
        else:
            _rel_close(got[k], w, rtol, f"{path}/{k}")


def _reference_params(model, cfg):
    """The port model's parameters as the reference's tree (``lm_tree``:
    stacked over periods), as JAX arrays: the same weights in both
    packages without the reference's (slow, eager) ``init_params``."""
    return jax.tree.map(jnp.asarray, _port_leaves_as_reference(
        dict(model.named_parameters()), cfg))


@pytest.fixture(scope="module")
def loss_grads():
    """Per config: the reference's (loss, metrics) and gradients from one
    compiled ``value_and_grad``, and the port's, on the same weights."""
    out = {}
    for name in CONFIGS:
        jcfg, tcfg, seq = _cfgs(name)
        tp = tlm.init_params(tcfg, seed=0)
        jp = _reference_params(tp, tcfg)
        batch = _batch(tcfg, seq)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, c=jcfg: jlm.loss_fn(p, c, b), has_aux=True))
        (jloss, jmet), jg = fn(jp, _j(batch))
        tloss, tmet = tlm.loss_fn(tp, tcfg, _t(batch))
        leaves = dict(tp.named_parameters())
        tg = torch.autograd.grad(tloss, list(leaves.values()))
        out[name] = (tcfg, (jloss, jmet, jax.tree.map(np.asarray, jg)),
                     (tloss, tmet, dict(zip(leaves, tg))))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_reference(loss_grads, name):
    """``loss_fn``'s loss, accuracy and token count, and every gradient
    leaf, against ``jax.value_and_grad(repro.models.lm.loss_fn)``."""
    tcfg, (jloss, jmet, jg), (tloss, tmet, tg) = loss_grads[name]
    tloss = float(tloss.detach())
    assert abs(tloss - float(jloss)) <= LOSS_ATOL
    assert abs(float(tmet["accuracy"]) - float(jmet["accuracy"])) <= 1e-6
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    assert float(tmet["loss"]) == tloss
    got = _port_leaves_as_reference(tg, tcfg)
    _tree_close(got, jg, GRAD_RTOL)
    assert all(float(g.abs().max()) > 0 for g in tg.values()
               if g.numel() > 1), "a leaf took no gradient"


def test_remat_equals_no_remat():
    """Recomputing each period in the backward gives the same loss and
    gradients bit for bit (MiniCPM's smoke config)."""
    cfg = get_config("minicpm_2b", smoke=True)
    model = tlm.init_params(cfg, seed=0)
    batch = _t(_batch(cfg, T))
    leaves = list(model.parameters())
    outs = []
    for remat in (True, False):
        loss, _ = tlm.loss_fn(model, cfg, batch, remat=remat)
        outs.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.fixture(scope="module")
def train_runs():
    """Two steps of ``make_train_step`` at accum 1 and 2 in both packages
    (momentum SGD at a constant rate of 1e-2, clipping to norm 1), the
    port's state converted from the reference's initial one."""
    jcfg, tcfg, seq = _cfgs("minicpm")
    sched = dict(kind="constant", lr=1e-2)
    out = {}
    for accum in (1, 2):
        jp = _reference_params(tlm.init_params(tcfg, seed=0), tcfg)
        jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                   opt=jopt.sgdm().init(jp))
        tstate = convert.train_state_from_numpy(
            jax.tree.map(np.asarray, jstate), tcfg, "cpu")
        jstep = jax.jit(jsteps.make_train_step(
            jcfg, jopt.sgdm(),
            jsch.make_schedule(jsch.ScheduleConfig(**sched)), accum=accum))
        tstep = tsteps.make_train_step(
            tcfg, topt.sgdm(),
            tsch.make_schedule(tsch.ScheduleConfig(**sched)), accum=accum)
        metrics = []
        for i in range(2):
            batch = _batch(tcfg, seq, seed=10 + i, batch=4)
            jstate, jm = jstep(jstate, _j(batch))
            tstate, tm = tstep(tstate, _t(batch))
            metrics.append((jm, tm))
        out[accum] = (tcfg, jax.tree.map(np.asarray, jstate), tstate,
                      metrics)
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(train_runs, accum):
    """Loss, accuracy, gradient norm and rate of each step; the parameters
    and momenta after two steps; the step counters."""
    tcfg, jstate, tstate, metrics = train_runs[accum]
    for jm, tm in metrics:
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
        assert abs(float(tm["accuracy"]) - float(jm["accuracy"])) <= 1e-6
        _rel_close(tm["grad_norm"], jm["grad_norm"], GRAD_RTOL)
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-9
    assert int(tstate.step) == int(jstate.step) == 2
    assert int(tstate.opt.step) == int(jstate.opt.step) == 2
    got = convert.train_state_to_numpy(tstate, tcfg)
    _tree_close(got.params, jstate.params, GRAD_RTOL)
    _tree_close(got.opt.inner, jstate.opt.inner, GRAD_RTOL)


def test_accumulated_step_averages_microbatches():
    """accum = 2 on a batch of 4 is the mean of the two halves' gradients
    (float32 sums): its gradient norm equals the norm of that mean, and
    its loss the mean of the halves' losses."""
    cfg = get_config("minicpm_2b", smoke=True)
    model = tlm.init_params(cfg, seed=1)
    batch = _t(_batch(cfg, T, seed=3, batch=4))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    leaves = list(model.parameters())
    losses, grads = [], []
    for h in halves:
        loss, _ = tlm.loss_fn(model, cfg, h)
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, leaves))
    mean = [(a + b) / 2 for a, b in zip(*grads)]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in mean))
    step = tsteps.make_train_step(cfg, topt.sgdm(), tsch.constant(0.0),
                                  accum=2, clip=1e9)
    state = tsteps.TrainState(torch.zeros((), dtype=torch.int32), model,
                              topt.sgdm().init(tsteps.param_dict(model)))
    _, m = step(state, batch)
    _rel_close(m["loss"], (losses[0] + losses[1]) / 2, 1e-6)
    _rel_close(m["grad_norm"], norm, 1e-5)


@pytest.mark.parametrize("groups", [(4, 2), (4, 4)])
def test_flash_attention_bwd_ref_matches_autograd(groups):
    """The backward kernel's plain version against autograd through the
    forward's plain version, float32, GQA 4/2 and MHA 4/4, T not a
    multiple of 64; and the CPU wrapper's gradient is autograd's."""
    H, Hkv = groups
    rng = np.random.default_rng(H + Hkv)
    q, k, v = (torch.tensor(rng.normal(size=(2, 70, h, 24)),
                            dtype=torch.float32, requires_grad=True)
               for h in (H, Hkv, Hkv))
    dout = torch.tensor(rng.normal(size=(2, 70, H, 24)), dtype=torch.float32)
    out = fref.flash_attention_ref(q, k, v)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = fref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       out.detach(), dout)
    for g, w in zip(got, want):
        _rel_close(g, w, 2e-6)
        assert g.dtype == torch.float32
    via_op = fops.attention_backward(q.detach(), k.detach(), v.detach(),
                                     out.detach(), dout)
    assert all(torch.equal(a, b) for a, b in zip(via_op, got))


def test_kernels_without_a_backward_refuse_gradients():
    """With grad mode on, the KPCA kernels refuse operands that require a
    gradient, naming the ROADMAP item (12); the LM kernels, whose
    backward is a kernel (``ssd_intra_chunk`` since its backward kernel,
    ``flash_attention``), take them.  Without grad mode, or without such
    an operand, nothing is refused.  The check runs before any CUDA work,
    so it is tested on CPU tensors."""
    x = torch.zeros(2, 3, requires_grad=True)
    for name in ("ssd_intra_chunk", "ssd_intra_chunk_bwd", "flash_attention",
                 "flash_attention_bwd"):
        cuda.check_grad(name, x)
    for name in ("eigvec_rotate", "eigvec_rotate2", "eigvec_project",
                 "krow_project", "transform_project", "scaled_gram",
                 "rbf_gram"):
        with pytest.raises(NotImplementedError, match="item 12"):
            cuda.check_grad(name, x)
    assert "11.4" not in cuda.NO_BACKWARD
    with torch.no_grad():
        cuda.check_grad("eigvec_rotate", x)
    cuda.check_grad("eigvec_rotate", x.detach())


def _driver(tmp, *extra):
    return ttrain.train(ttrain.parse_args(
        ["--device", "cpu", "--smoke", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt-dir", str(tmp), "--ckpt-every", "2",
         *extra]))


def test_train_driver_resumes_bit_for_bit_and_checkpoints_cross_load(
        tmp_path):
    """``launch/train --device cpu --smoke`` for 4 steps writes checkpoints
    at steps 2 and 4; a run resumed from step 2 ends on the same state bit
    for bit.  The reference's ``load_checkpoint`` reads the port's
    checkpoint into its ``TrainState`` (leaf for leaf the port's state),
    and the port reads one the reference wrote."""
    full, state = _driver(tmp_path / "a", "--steps", "4")
    assert full["steps"] == 4 and np.isfinite(full["last_loss"])
    _driver(tmp_path / "b", "--steps", "2")
    resumed, state_b = _driver(tmp_path / "b", "--steps", "4", "--resume")
    assert resumed["last_loss"] == full["last_loss"]
    assert int(state_b.step) == int(state.step) == 4
    for (na, a), (nb, b) in zip(state.params.named_parameters(),
                                state_b.params.named_parameters()):
        assert na == nb and torch.equal(a, b)
    for k in ("mu", "nu"):
        for n, t in state.opt.inner[k].items():
            assert torch.equal(t, state_b.opt.inner[k][n])

    # The reference reads the port's checkpoint.
    jcfg = j_get_config("minicpm_2b", smoke=True)
    tcfg = get_config("minicpm_2b", smoke=True)
    shapes = jax.eval_shape(lambda key: jsteps.init_train_state(
        key, jcfg, jopt.adamw()), jax.random.PRNGKey(0))
    loaded = j_load(str(tmp_path / "a"), 4, shapes)
    mine = convert.train_state_to_numpy(state, tcfg)
    assert int(loaded.step) == 4 and int(loaded.opt.step) == 4
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        np.asarray, loaded))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert len(flat_j) == len(flat_t)
    for path, arr in flat_j:
        assert np.array_equal(np.asarray(arr, np.float32),
                              np.asarray(flat_t[path], np.float32)), path

    # The port reads a checkpoint the reference wrote (of a state two
    # steps further on, moments included).
    jstate = jax.tree.map(jnp.asarray, convert.train_state_to_numpy(
        state_b, tcfg))
    jstate = jsteps.TrainState(step=jnp.asarray(7, jnp.int32),
                               params=jstate.params, opt=jstate.opt)
    j_save(str(tmp_path / "ref"), 7, jstate)
    target = convert.train_state_tree(state, tcfg)
    got = convert.train_state_from_numpy(
        load_checkpoint(str(tmp_path / "ref"), 7, target), tcfg, "cpu")
    assert int(got.step) == 7 and int(got.opt.step) == 4
    back = convert.train_state_to_numpy(got, tcfg)
    _tree_close(back.params, jax.tree.map(np.asarray, jstate.params), 0.0)
    _tree_close(back.opt.inner, jax.tree.map(np.asarray, jstate.opt.inner),
                0.0)
    assert all(p.requires_grad for p in got.params.parameters())
