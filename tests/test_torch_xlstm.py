"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's, at smoke width in float32 on the same weights (the
reference's ``mlstm_init`` / ``slstm_init`` trees through
``convert.load_numpy_``) and the same numpy inputs: the parallel forms,
the recurrent decode step by step, and the mLSTM's invariance to its
chunk.

Held at 1e-4 absolute, the bar of ``tests/test_torch_models.py`` and of
the reference's own decode-against-parallel and chunk-invariance tests
(``tests/test_models.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as jx  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

ATOL = 1e-4
B, T = 2, 16
# d_in = 128 over 4 heads of 32; T = 16 is two chunks of 8.
BASE = dict(name="t", family="ssm", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=0, vocab=128, ssm_chunk=8, dtype="float32")
MODULES = {"mlstm": tx.MLSTM, "slstm": tx.SLSTM}


def _block(kind, seed=3, **kw):
    jcfg, tcfg = JArchConfig(**{**BASE, **kw}), ArchConfig(**{**BASE, **kw})
    jp = getattr(jx, f"{kind}_init")(jax.random.PRNGKey(seed), jcfg)
    tp = convert.load_numpy_(MODULES[kind](tcfg, "meta"),
                             jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(seed) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(B, T, 64)) * 0.5
            ).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_apply_matches_reference(kind):
    jcfg, tcfg, jp, tp = _block(kind)
    x = _x(4)
    _close(getattr(tx, f"{kind}_apply")(tp, tcfg, torch.from_numpy(x)),
           getattr(jx, f"{kind}_apply")(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_reference_and_the_parallel_form(kind):
    """Each step's output and the final state against the reference's
    decode; the port's steps together against its own parallel form."""
    jcfg, tcfg, jp, tp = _block(kind, seed=5)
    x = _x(6)
    jc = getattr(jx, f"{kind}_cache_init")(jcfg, B)
    tc = getattr(tx, f"{kind}_cache_init")(tcfg, B)
    outs = []
    jdecode = getattr(jx, f"{kind}_decode")
    jstep = jax.jit(lambda p, x, c: jdecode(p, jcfg, x, c))
    for t in range(T):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = getattr(tx, f"{kind}_decode")(
            tp, tcfg, torch.from_numpy(x[:, t:t + 1]), tc)
        _close(ty, jy)
        outs.append(ty)
    for key in tc:
        _close(tc[key], jc[key])
    _close(torch.cat(outs, 1),
           getattr(tx, f"{kind}_apply")(tp, tcfg, torch.from_numpy(x)))


@pytest.mark.parametrize("chunk", [4, 16])
def test_mlstm_chunk_invariance(chunk):
    """The chunked mLSTM does not depend on the chunk: chunks of 4 and one
    chunk of 16 against chunks of 8 in the port, and against the
    reference at the same chunk."""
    jcfg, tcfg, jp, tp = _block("mlstm", seed=7, ssm_chunk=chunk)
    _, tcfg8, _, _ = _block("mlstm", seed=7)
    x = torch.from_numpy(_x(8) * 2.0)
    got = tx.mlstm_apply(tp, tcfg, x)
    _close(got, tx.mlstm_apply(tp, tcfg8, x))
    _close(got, jx.mlstm_apply(jp, jcfg, jnp.asarray(x.numpy())))


def test_mlstm_refuses_a_ragged_sequence():
    """T must be a multiple of the chunk, as in the reference (whose
    reshape fails there)."""
    _, tcfg, _, tp = _block("mlstm")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tx.mlstm_apply(tp, tcfg, torch.zeros(B, 12, 64))
