"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the reference's, at smoke width in float32 on the same weights (the
reference's ``moe_init`` tree through ``convert.load_numpy_``) and the same
numpy inputs.

Held at 1e-4 absolute, the bar of ``tests/test_torch_models.py``: both
sides compute in float32, in different orders.  The slot positions are
integers and are held exactly.  A capacity factor of 0.5 makes the drops
bind; 8.0 drops nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

ATOL = 1e-4
B, T, E, K = 2, 16, 4, 2
BASE = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=0, vocab=128, dtype="float32")


def _cfgs(capacity_factor=1.25, impl="einsum"):
    """The same expert config in both packages: 4 experts, top 2, one
    shared expert."""
    mo = dict(n_experts=E, top_k=K, d_ff_expert=32, n_shared_experts=1,
              capacity_factor=capacity_factor, impl=impl)
    return (JArchConfig(**BASE, moe=JMoEConfig(**mo)),
            ArchConfig(**BASE, moe=MoEConfig(**mo)))


def _params(jcfg, tcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.load_numpy_(tmoe.MoE(tcfg, "meta"),
                             jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _x(seed=7) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, T, 64)).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("with_counts", [False, True])
def test_causal_positions_match_reference_exactly(with_counts):
    rng = np.random.default_rng(3)
    ids = np.stack([rng.permutation(E)[:K] for _ in range(B * T)]
                   ).reshape(B, T, K)
    onehot = np.eye(E, dtype=np.int32)[ids]
    counts0 = rng.integers(0, 9, (B, E)).astype(np.int32)
    jpos, jcounts = jmoe._causal_positions(
        jnp.asarray(onehot), jnp.asarray(counts0) if with_counts else None)
    tpos, tcounts = tmoe._causal_positions(
        torch.from_numpy(onehot).long(),
        torch.from_numpy(counts0).long() if with_counts else None)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert np.array_equal(tcounts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_apply_matches_reference(impl, capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor, impl)
    jp, tp = _params(jcfg, tcfg)
    x = _x()
    got = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    _close(got, jmoe.moe_apply(jp, jcfg, jnp.asarray(x)))
    keep = tmoe._route(tp, tcfg, torch.from_numpy(x))[3]
    assert bool(keep.all()) == (capacity_factor == 8.0)   # drops bind


def test_ep_without_a_mesh_is_einsum():
    """``impl='ep'`` without a mesh runs the einsum dispatch, in both
    packages: the port's equals its einsum bit for bit and the
    reference's ``ep`` within the bar, with the drops binding."""
    jcfg, tcfg = _cfgs(0.5, "ep")
    _, tcfg_e = _cfgs(0.5, "einsum")
    jp, tp = _params(jcfg, tcfg, seed=1)
    x = torch.from_numpy(_x(8))
    got = tmoe.moe_apply(tp, tcfg, x)
    assert torch.equal(got, tmoe.moe_apply(tp, tcfg_e, x))
    _close(got, jmoe.moe_apply(jp, jcfg, jnp.asarray(x.numpy())))


def test_moe_decode_matches_reference_step_by_step():
    """Token by token against the reference's ``moe_decode`` under binding
    drops (capacity factor 0.5), the counts included; then against the
    parallel ``moe_apply``, which the count cache replays."""
    jcfg, tcfg = _cfgs(0.5)
    jp, tp = _params(jcfg, tcfg, seed=2)
    x = _x(9)
    jc = jmoe.moe_cache_init(jcfg, B, T)
    tc = tmoe.moe_cache_init(tcfg, B, T)
    assert tc["capacity"] == int(jc["capacity"])
    outs = []
    for t in range(T):
        jy, jc = jmoe.moe_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tmoe.moe_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                 tc)
        _close(ty, jy)
        assert np.array_equal(tc["counts"].numpy(), np.asarray(jc["counts"]))
        outs.append(ty)
    _close(torch.cat(outs, 1), tmoe.moe_apply(tp, tcfg, torch.from_numpy(x)))


def _chip_smoke():
    import importlib
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_recorded_routes_see_prefill_and_decode_and_restore():
    """``chip_smoke.recorded_routes`` records each MoE call's expert ids
    and slot positions (one call a layer for the forward, one a layer a
    step for decode) and puts the module's functions back on leaving;
    the routes of the f32 smoke model agree everywhere."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("dbrx_132b", smoke=True)
    params = lm.init_params(cfg, seed=0)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, T)))
    router = tmoe._router
    with cs.recorded_routes(tmoe) as log_p:
        lm.forward(params, cfg, prompt)
    caches = lm.init_caches(params, cfg, 1, T)
    with cs.recorded_routes(tmoe) as log_d:
        for t in range(T):
            _, caches = lm.decode_step(params, cfg, caches,
                                       prompt[:, t:t + 1],
                                       torch.full((1, 1), t))
    assert tmoe._router is router
    assert (len(log_p["idx"]), len(log_d["idx"])) == (2, 2 * T)
    report, agree = cs._route_agreement(torch, cfg, log_p, log_d, T)
    assert report["choice_agreement"] == 1.0 and bool(agree.all())


def test_route_agreement_counts_choices_up_to_the_first_flip():
    """Token 1 flips in layer 0 (its layer-1 choices, all other, follow
    from it and are not counted up to the first flip), token 2 in layer 1
    only: 8 of 12 choices agree, 8 of the 10 up to the first flips."""
    cs = _chip_smoke()
    _, tcfg = _cfgs(8.0)
    pre = [torch.tensor([[0, 1], [0, 1], [2, 3]]),
           torch.tensor([[0, 1], [2, 3], [0, 1]])]
    dec = {0: ([0, 1], [0, 2], [2, 3]), 1: ([0, 1], [0, 1], [0, 2])}
    pos = [torch.zeros(3, 2, dtype=torch.long)] * 2
    dec_idx = [torch.tensor([dec[layer][t]]) for t in range(3)
               for layer in range(2)]
    report, agree = cs._route_agreement(
        torch, tcfg, {"idx": pre, "pos": pos},
        {"idx": dec_idx, "pos": [p[:1] for p in pos] * 3}, 3)
    assert report["choice_agreement"] == pytest.approx(8 / 12)
    assert report["choices_to_first_flip"] == 10
    assert report["choice_agreement_to_first_flip"] == pytest.approx(8 / 10)
    assert report["first_flip_by_layer"] == [1, 1]
    assert agree.tolist() == [True, False, False]
