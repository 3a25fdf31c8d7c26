"""The per-entry tolerances ``repro_torch.kernels.checks`` holds each CUDA
kernel to, exercised on the CPU.

On the CPU a wrapper runs its plain version, so ``compare`` of a case
against itself is trivially exact.  These tests instead stand a second,
float64-accumulated evaluation of each function in for the kernel (it
must pass: its rounding differs from the plain version's, within the
bound), and feed ``compare`` outputs with one column wrong (it must
refuse them, also where that column's entries are small beside the
output's others, as the k-row projection's Uᵀa is beside Uᵀk1).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.eigvec_update import ops as eops  # noqa: E402
from repro_torch.kernels.eigvec_update import ref as eref  # noqa: E402
from repro_torch.kernels.nystrom_recon import ops as nops  # noqa: E402
from repro_torch.kernels.nystrom_recon.ref import (  # noqa: E402
    scaled_gram_ref, transform_project_ref)
from repro_torch.kernels.rbf_gram import ops as kops  # noqa: E402
from repro_torch.kernels.rbf_gram.ref import krow_project_ref  # noqa: E402

N = 96
NAMES = ("eigvec_rotate", "eigvec_rotate2", "eigvec_project",
         "krow_project", "transform_project", "scaled_gram")


def _case(name, m, dtype=torch.float32, seed=0):
    """``name``'s case at bucket N with m active pairs (scaled_gram: B of
    width m, its own row count being unrelated to the bucket)."""
    if name == "scaled_gram":
        return checks.gram_cases(N, m, dtype, "cpu", seed=seed)[0]
    return next(c for c in checks.cases(N, m, dtype, "cpu", seed=seed)
                if c.name == name)


def _in_f64(fn):
    """``fn`` evaluated on float64 copies of its float operands, each
    output rounded back to the operands' type."""
    def wrapped(*args, **kw):
        dtype = args[0].dtype
        up = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
              else a for a in args]
        out = fn(*up, **kw)
        if isinstance(out, tuple):
            return tuple(o.to(dtype) for o in out)
        return out.to(dtype)
    return wrapped


@pytest.mark.parametrize("m", [1, 64, 90, N])
@pytest.mark.parametrize("name", NAMES)
def test_a_more_accurate_evaluation_passes(monkeypatch, name, m):
    monkeypatch.setattr(eops, "rotate_vectors", _in_f64(
        lambda u, z, d, lam, inv, m, *, tau:
        eref.eigvec_rotate_ref(u, z, d, lam, inv, tau)))
    monkeypatch.setattr(eops, "rotate_vectors2", _in_f64(
        lambda u, *ops, **taus: eref.eigvec_rotate2_ref(u, *ops[:12],
                                                        **taus)))
    monkeypatch.setattr(eops, "project_vectors",
                        _in_f64(eref.eigvec_project_ref))
    monkeypatch.setattr(nops, "scaled_gram", _in_f64(scaled_gram_ref))
    monkeypatch.setattr(kops, "krow_project", _in_f64(krow_project_ref))
    monkeypatch.setattr(nops, "transform_project",
                        _in_f64(transform_project_ref))
    case = _case(name, m)
    res = checks.compare(case)
    assert 0.0 <= res["max_err_over_tol"] <= 1.0
    # The rounding differs from the plain version's: not a trivial pass.
    if m > 1:
        assert res["max_abs_err"] > 0.0


def _with_column(case, output, col, fn):
    def kernel():
        outs = [o.clone() for o in case.kernel()]
        o = outs[output]
        if o.dim() == 1:
            outs[output] = fn(o)
        else:
            o[:, col] = fn(o[:, col])
        return tuple(outs)
    return dataclasses.replace(case, kernel=kernel)


@pytest.mark.parametrize("name,output,col,fn", [
    # krow's P = Uᵀ[a | 1 | k1]: column 0 is small beside column 2.
    ("krow_project", 1, 0, torch.zeros_like),
    ("krow_project", 1, 0, lambda c: c * (1 + 1e-2)),
    ("krow_project", 0, None, lambda a: a * (1 + 1e-2)),
    ("eigvec_rotate", 0, 3, lambda c: c * (1 + 1e-3)),
    ("eigvec_rotate2", 0, 5, torch.zeros_like),
    ("eigvec_rotate2", 0, 5, lambda c: c * (1 + 1e-3)),
    ("scaled_gram", 0, 7, torch.zeros_like),
    ("scaled_gram", 0, 7, lambda c: c * (1 + 1e-3)),
    ("eigvec_project", 0, 1, lambda c: c * (1 + 1e-3)),
    ("transform_project", 0, 0, lambda c: c * (1 + 1e-3)),
    ("transform_project", 1, None, lambda r: r * (1 + 1e-3)),
], ids=["krow_P_col0_zero", "krow_P_col0_1e-2", "krow_a_1e-2",
        "rotate_col_1e-3", "rotate2_col_zero", "rotate2_col_1e-3",
        "gram_col_zero", "gram_col_1e-3", "project_col_1e-3", "transform_Y_col_1e-3",
        "transform_rowsum_1e-3"])
def test_a_wrong_column_is_refused(name, output, col, fn):
    case = _case(name, 90)
    checks.compare(case)
    with pytest.raises(AssertionError, match="exceeds its bound"):
        checks.compare(_with_column(case, output, col, fn))


def test_krow_column_bounds_follow_their_own_scale():
    """The bound on Uᵀa sits well below Uᵀa's own entries, and far below
    the bound on Uᵀk1 (k1 ~ 100), which one scalar bound would apply to
    both."""
    case = _case("krow_project", 90)
    _, P = case.plain()
    tol = case.tols[1]
    col0 = P[:90, 0].abs()
    assert float(tol[:90, 0].max()) < 1e-2 * float(col0.median())
    assert float(tol[:, 0].max()) < 1e-2 * float(tol[:, 2].max())
