"""The port's LM zoo (``repro_torch.models``) against the reference's, at
smoke width in float32 on the same weights: the blocks' reference trees go
to the port through ``convert.load_numpy_``, the whole models' port
weights to the reference through ``convert.lm_tree`` (and
``convert.lm_params_from_numpy`` is held leaf for leaf); the inputs are
the same numpy arrays.

Held at 1e-4 absolute, the reference's own bar between its naive and
flash attention (``tests/test_models.py``): both sides compute in float32,
in different orders.  Then, in the port alone, decode against the
parallel forward (the reference's 2e-2) and causality.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

ATOL = 1e-4
B, T = 2, 16

BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=128, dtype="float32")
HYBRID = dict(family="hybrid", n_layers=4, block_pattern=("mamba", "attn"),
              ssm_d_state=8, ssm_head_dim=16, ssm_chunk=8)


def _cfgs(**kw):
    """The same config in both packages."""
    args = {**BASE, **kw}
    return JArchConfig(**args), ArchConfig(**args)


def _smoke(arch, **kw):
    """An architecture's smoke config in both packages, equal field for
    field, with ``kw`` replaced in both."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _x(shape, seed, scale=0.5) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _tokens(cfg, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T))


def test_rmsnorm_matches_reference():
    x = _x((B, T, 64), 0, 2.0)
    scale = _x((64,), 1) + 1.0
    p = convert.load_numpy_(tl.RMSNorm(64, torch.float32, "meta"),
                            {"scale": scale}, "cpu")
    _close(tl.rmsnorm_apply(p, torch.from_numpy(x)),
           jl.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_apply_rope_matches_reference(fraction):
    hd = 16
    x = _x((B, T, 4, hd), 2)
    pos = np.broadcast_to(np.arange(T) + 3, (B, T))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                         jl.rope_freqs(hd, 10_000.0, fraction))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        tl.rope_freqs(hd, 10_000.0, fraction))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_apply_matches_reference(impl, qk_norm):
    jcfg, tcfg = _cfgs(qk_norm=qk_norm, attn_impl=impl, flash_block=8,
                       rope_fraction=0.5)
    jp = jl.attention_init(jax.random.PRNGKey(0), jcfg)
    tp = convert.load_numpy_(tl.Attention(tcfg, "meta"), _tree(jp), "cpu")
    x = _x((B, T, 64), 3)
    pos = np.broadcast_to(np.arange(T), (B, T))
    _close(tl.attention_apply(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy())),
           jl.attention_apply(jp, jcfg, jnp.asarray(x),
                              jnp.asarray(pos, jnp.int32)))


def test_attention_decode_matches_reference():
    jcfg, tcfg = _cfgs(qk_norm=True)
    jp = jl.attention_init(jax.random.PRNGKey(1), jcfg)
    tp = convert.load_numpy_(tl.Attention(tcfg, "meta"), _tree(jp), "cpu")
    x = _x((B, T, 64), 4)
    jc = jl.attention_cache_init(jcfg, B, T)
    tc = tl.attention_cache_init(tcfg, B, T)
    jstep = jax.jit(lambda p, x, c, pos: jl.attention_decode(p, jcfg, x, c,
                                                             pos))
    for t in range(T):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc,
                       jnp.full((B, 1), t, jnp.int32))
        ty, tc = tl.attention_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                     tc, torch.full((B, 1), t))
        _close(ty, jy)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches_reference(act):
    jcfg, tcfg = _cfgs(act=act)
    jp = jl.mlp_init(jax.random.PRNGKey(2), jcfg)
    tp = convert.load_numpy_(tl.MLP(tcfg, device="meta"), _tree(jp), "cpu")
    x = _x((B, T, 64), 5)
    _close(tl.mlp_apply(tp, tcfg, torch.from_numpy(x)),
           jl.mlp_apply(jp, jcfg, jnp.asarray(x)))


def _mamba(seed=3):
    jcfg, tcfg = _cfgs(**HYBRID)
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.load_numpy_(tssm.Mamba(tcfg, "meta"), _tree(jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_mamba_apply_matches_reference():
    """Two chunks of 8: the kernel's intra-chunk term and the chunk state
    carried from the first chunk into the second."""
    jcfg, tcfg, jp, tp = _mamba()
    x = _x((B, T, 64), 6)
    _close(tssm.mamba_apply(tp, tcfg, torch.from_numpy(x)),
           jssm.mamba_apply(jp, jcfg, jnp.asarray(x)))


def test_mamba_decode_matches_reference():
    jcfg, tcfg, jp, tp = _mamba(seed=4)
    x = _x((B, T, 64), 7)
    jc, tc = jssm.mamba_cache_init(jcfg, B), tssm.mamba_cache_init(tcfg, B)
    jstep = jax.jit(lambda p, x, c: jssm.mamba_decode(p, jcfg, x, c))
    for t in range(T):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tssm.mamba_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                   tc)
        _close(ty, jy)
    _close(tc["S"], jc["S"])
    _close(tc["conv_buf"], jc["conv_buf"])


# The dense GQA config with qk_norm, and one with a parallel block, tied
# embeddings, a logit soft cap and a residual scale.
DENSE = {"dense_gqa_qk_norm": dict(qk_norm=True),
         "dense_parallel_tied": dict(parallel_block=True,
                                     tie_embeddings=True,
                                     logit_soft_cap=30.0,
                                     residual_scale=0.5, act="gelu")}
# Registry smoke configs: Jamba with its experts (odd layers) and without
# them, DBRX (top-2 of 4 experts every layer), Kimi (a shared expert and
# qk_norm) and xLSTM (5 mLSTM + 1 sLSTM layers, two chunks of 8).
SMOKE = {"jamba": ("jamba_1_5_large_398b", {}),
         "jamba_dense": ("jamba_1_5_large_398b", {"moe": None}),
         "dbrx": ("dbrx_132b", {}), "kimi": ("kimi_k2_1t_a32b", {}),
         "xlstm": ("xlstm_125m", {})}


def _models(name):
    """Both packages' models on the same weights: the port's drawn from
    seed 0 (by the reference's distributions) and handed to the reference
    as its tree (``convert.lm_tree``, stacked over periods), which skips
    the reference's eager ``init_params`` (~10 s for Jamba's smoke config
    on a CPU).  The reference-to-port direction is held by
    ``test_converted_leaves_keep_their_type`` and
    ``test_embed_tokens_takes_frontend_embeddings``."""
    jcfg, tcfg = (_smoke(SMOKE[name][0], **SMOKE[name][1]) if name in SMOKE
                  else _cfgs(**DENSE[name]))
    tp = tlm.init_params(tcfg, seed=0)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), convert.lm_tree(
        {k: p.detach() for k, p in tp.named_parameters()}, tcfg))
    return jcfg, tcfg, params, tp


@pytest.mark.parametrize("name", [*SMOKE, *DENSE])
def test_lm_forward_and_decode_match_reference(name):
    """The forward, then decode streamed token by token (one jitted
    reference step, compiled once), logits at every step; the decode's
    caches are built at T, so an MoE layer's capacity is the forward's."""
    jcfg, tcfg, jp, tp = _models(name)
    tokens = _tokens(tcfg)
    _close(tlm.forward(tp, tcfg, torch.from_numpy(tokens)),
           jlm.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32),
                       remat=False))
    jc = jlm.init_caches(jp, jcfg, B, T)
    tc = tlm.init_caches(tp, tcfg, B, T)
    jstep = jax.jit(lambda p, c, tok, pos: jlm.decode_step(p, jcfg, c, tok,
                                                           pos))
    for t in range(T):
        jlog, jc = jstep(jp, jc, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                         jnp.full((B, 1), t, jnp.int32))
        tlog, tc = tlm.decode_step(tp, tcfg, tc,
                                   torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.full((B, 1), t))
        _close(tlog, jlog)


def test_embed_tokens_takes_frontend_embeddings():
    """A modality frontend's first ``frontend_len`` positions come from
    precomputed embeddings, the rest from the table, as in the
    reference."""
    jcfg, tcfg = _cfgs(frontend="embeddings", frontend_len=4)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(_tree(jp), tcfg, "cpu")
    tokens, emb = _tokens(tcfg), _x((B, 4, 64), 8)
    _close(tlm.embed_tokens(tp, tcfg, torch.from_numpy(tokens),
                            torch.from_numpy(emb)),
           jlm.embed_tokens(jp, jcfg, jnp.asarray(tokens, jnp.int32),
                            jnp.asarray(emb)), 0.0)


def test_frontend_embeddings_match_the_references_contract():
    """``frontend_embeddings`` as the reference's: a frontend config's batch
    gains (B, frontend_len, d_model) embeddings of scale 0.02 in the
    model's type, its labels over those positions become -1, the rest
    unchanged; the draws are a function of the seed; a token-only config's
    batch is returned as it is."""
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn

    jcfg, tcfg = _smoke("pixtral_12b")
    tokens = _tokens(tcfg)
    labels = np.roll(tokens, -1, axis=1)
    want = jsyn.frontend_embeddings(jcfg, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    got = tsyn.frontend_embeddings(tcfg, batch)
    assert got["embeddings"].shape == want["embeddings"].shape
    assert got["embeddings"].dtype == torch.float32
    assert np.array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert 0.01 < float(got["embeddings"].std()) < 0.03
    assert torch.equal(got["embeddings"],
                       tsyn.frontend_embeddings(tcfg, batch)["embeddings"])
    assert not torch.equal(got["embeddings"], tsyn.frontend_embeddings(
        tcfg, batch, seed=8)["embeddings"])
    assert tsyn.frontend_embeddings(get_config("qwen3_32b", smoke=True),
                                    batch) is batch
    assert torch.equal(batch["labels"], torch.from_numpy(labels))


def test_converted_leaves_keep_their_type():
    """A bfloat16 model's float32 leaves (dt_bias, a_log, d_skip, the
    router) stay float32; every other leaf is bfloat16, value for value."""
    jcfg, tcfg = _smoke("jamba_1_5_large_398b", dtype="bfloat16")
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_numpy(_tree(params), tcfg, "cpu")
    mamba = model.layers[0].mixer
    for leaf in ("dt_bias", "a_log", "d_skip"):
        assert getattr(mamba, leaf).dtype == torch.float32
    assert mamba.in_proj.dtype == torch.bfloat16
    assert model.layers[3].kind == "attn"
    want = np.asarray(params["slots"]["slot3"]["mixer"]["wq"][0], np.float32)
    assert np.array_equal(model.layers[3].mixer.wq.float().numpy(), want)
    experts = model.layers[1].ffn
    assert (model.layers[1].ffn_kind, model.layers[2].ffn_kind) == ("moe",
                                                                    "dense")
    assert experts.router.dtype == torch.float32
    assert experts.w_down.dtype == torch.bfloat16
    want = np.asarray(params["slots"]["slot1"]["ffn"]["w_up"][0], np.float32)
    assert np.array_equal(experts.w_up.float().numpy(), want)


def _port_model(name):
    cfg = (get_config("jamba_1_5_large_398b", smoke=True) if name == "jamba"
           else ArchConfig(**{**BASE, "qk_norm": True}))
    return cfg, tlm.init_params(cfg, seed=0)


@pytest.mark.parametrize("name", ["jamba", "dense_gqa_qk_norm"])
def test_port_decode_matches_parallel(name):
    cfg, params = _port_model(name)
    tokens = torch.from_numpy(_tokens(cfg))
    full = tlm.forward(params, cfg, tokens)
    caches = tlm.init_caches(params, cfg, B, T)
    outs = []
    for t in range(T):
        lg, caches = tlm.decode_step(params, cfg, caches, tokens[:, t:t + 1],
                                     torch.full((B, 1), t))
        outs.append(lg)
    assert float((full - torch.cat(outs, 1)).abs().max()) < 2e-2


@pytest.mark.parametrize("name", ["jamba", "dense_gqa_qk_norm"])
def test_port_causality(name):
    """A change to the last token leaves every earlier position's logits as
    they were."""
    cfg, params = _port_model(name)
    tokens = torch.from_numpy(_tokens(cfg))
    l1 = tlm.forward(params, cfg, tokens)
    tokens2 = tokens.clone()
    tokens2[:, -1] = (tokens2[:, -1] + 1) % cfg.vocab
    l2 = tlm.forward(params, cfg, tokens2)
    assert float((l1[:, :-1] - l2[:, :-1]).abs().max()) < 1e-5


def test_unported_blocks_raise():
    """Nyström attention is ported (ROADMAP.md §1 item 11.1): its config
    builds Nyström layers, the forward runs over two chunks, decode keeps
    a ``NystromCache`` per layer and gives finite logits; an unknown
    attention kind still raises.  (Its parity with the reference:
    ``test_torch_nystrom_attention.py``, ``test_torch_train.py``.)"""
    from repro_torch.models import nystrom_attention as tnys

    cfg = ArchConfig(**{**BASE, "attention": "nystrom",
                        "nystrom_landmarks": 8})
    params = tlm.init_params(cfg, seed=0)
    assert all(isinstance(layer.mixer, tnys.NystromAttention)
               for layer in params.layers)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, 256)))
    full = tlm.forward(params, cfg, tokens)
    assert full.shape == (B, 256, cfg.vocab) and bool(
        torch.isfinite(full).all())
    caches = tlm.init_caches(params, cfg, B, 4)
    assert isinstance(caches[0]["mixer"], tnys.NystromCache)
    for t in range(4):
        logits, caches = tlm.decode_step(params, cfg, caches,
                                         tokens[:, t:t + 1],
                                         torch.full((B, 1), t))
        assert logits.shape == (B, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="attention"):
        tlm.LM(ArchConfig(**{**BASE, "attention": "linear"}), "meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_configs_equal_the_references(arch):
    """Every reference id is registered, full and smoke, field for field
    the reference's (Jamba with its experts); the training path's module
    constants stay beside the configs."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS

    assert ARCH_IDS == J_ARCH_IDS
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                == dataclasses.asdict(j_get_config(arch, smoke=smoke)))
    assert get_config(arch.replace("_", "-")) == get_config(arch)
    consts = {"kimi_k2_1t_a32b": ("OPTIMIZER", "adafactor"),
              "minicpm_2b": ("SCHEDULE", "wsd")}
    if arch in consts:
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        assert getattr(mod, consts[arch][0]) == consts[arch][1]


def test_token_stream_is_a_function_of_seed_and_step():
    """The same (seed, step) gives the same batch, another step another;
    labels are the next tokens (-1 last); about half the transitions follow
    the stream's fixed permutation (the Markov structure)."""
    from repro_torch.data.synthetic import TokenStream

    ts = TokenStream(vocab=64, seq_len=200, global_batch=3, seed=5)
    a, b, c = ts.batch_at(2), ts.batch_at(2), ts.batch_at(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    tok, lab = a["tokens"], a["labels"]
    assert tok.shape == (3, 200) and int(tok.min()) >= 0 and int(tok.max()) < 64
    assert torch.equal(lab[:, :-1], tok[:, 1:]) and bool((lab[:, -1] == -1).all())
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(6))
    follows = float((perm[tok[:, :-1]] == tok[:, 1:]).float().mean())
    assert 0.4 < follows < 0.7
