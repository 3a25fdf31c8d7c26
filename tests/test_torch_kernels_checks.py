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
from repro_torch.kernels.rbf_gram.ref import (  # noqa: E402
    krow_project_ref, rbf_gram_ref)
from repro_torch.testing.threads import one_torch_thread  # noqa: E402,F401

N = 96
NAMES = ("eigvec_rotate", "eigvec_rotate2", "eigvec_project",
         "krow_project", "transform_project", "scaled_gram", "rbf_gram")


def _case(name, m, dtype=torch.float32, seed=0):
    """``name``'s case at bucket N with m active pairs (scaled_gram: B of
    width m, its own row count being unrelated to the bucket; rbf_gram:
    the gram of N points against m, of 16 features)."""
    if name == "scaled_gram":
        return checks.gram_cases(N, m, dtype, "cpu", seed=seed)[0]
    if name == "rbf_gram":
        return checks.rbf_gram_cases(N, m, 16, dtype, "cpu", seed=seed)[0]
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
    monkeypatch.setattr(kops, "gram", _in_f64(rbf_gram_ref))
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
    ("rbf_gram", 0, 7, torch.zeros_like),
    ("rbf_gram", 0, 7, lambda c: c * (1 + 1e-4)),
], ids=["krow_P_col0_zero", "krow_P_col0_1e-2", "krow_a_1e-2",
        "rotate_col_1e-3", "rotate2_col_zero", "rotate2_col_1e-3",
        "gram_col_zero", "gram_col_1e-3", "project_col_1e-3", "transform_Y_col_1e-3",
        "transform_rowsum_1e-3", "rbf_gram_col_zero", "rbf_gram_col_1e-4"])
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


@pytest.mark.parametrize("n, m, dim, dtype, want_ms, want_by", [
    # The roofline's k(X, X): x read once, one triangle of dot products;
    # 4.46 MB at 3.35 TB/s against 69.7 MFLOP at 67 TFLOP/s.
    (1024, 1024, 64, torch.float32, 4 * (1024 * 64 + 1024**2) / 3.35e9,
     "bytes"),
    # Two inputs: both read, every entry a dot product (operations).
    (1024, 512, 64, torch.float32, 1024 * 512 * (2 * 64 + 4) / 67e9,
     "operations"),
    # float64 at a width where the products bind, on DMMA's 67 TFLOP/s.
    (1024, 512, 256, torch.float64, 1024 * 512 * (2 * 256 + 4) / 67e9,
     "operations"),
], ids=["symmetric", "rectangular", "rectangular_f64_wide"])
def test_rbf_gram_bound_counts_the_work_its_call_needs(n, m, dim, dtype,
                                                       want_ms, want_by):
    """Where y is x the gram is symmetric: its bound reads x once and
    counts n(n+1)/2 dot products; a second input is read and every entry
    counted.  A dot product is 2d flops at 67 TFLOP/s (float32 on the CUDA
    cores, float64 on DMMA); each entry adds 4 flops of the norm
    expansion."""
    case = checks.rbf_gram_cases(n, m, dim, dtype, "cpu")[0]
    sym = n == m
    item = 4 if dtype == torch.float32 else 8
    assert case.bytes == item * (n * dim + (0 if sym else m * dim) + n * m)
    entries = n * (n + 1) / 2 if sym else n * m
    assert case.flops == entries * (2 * dim + 4)
    ms, by = case.bound(dtype)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-12)


def test_roofline_counts_the_grams_as_the_checks_do():
    """The roofline's ``rbf_gram`` (k(X, X)) and ``nystrom_recon`` rows
    count the bytes and operations of ``checks``' cases on the same
    operands (one triangle, the operand read once) against the peak of the
    route the kernels run: 67 TFLOP/s for ``rbf_gram`` (float32 FMAs on
    the CUDA cores), 495 TFLOP/s for ``nystrom_recon`` (TF32 products);
    the other rows keep the float32 67 TFLOP/s."""
    from repro_torch.launch import roofline

    M, d, Q, C = 64, 16, 32, 8
    rows = {r["kernel"]: r for r in roofline.kernel_rows(
        M, d, Q, C, reps=1, peak_gbps=1.0, device=torch.device("cpu"))}
    x = torch.zeros(M, d)
    b, s = torch.zeros(Q, M), torch.ones(M)
    for name, case, peak in (
            ("rbf_gram", checks.rbf_gram_case(x, x, d), 67e12),
            ("nystrom_recon", checks.scaled_gram_case(b, s),
             checks.TF32_FLOPS)):
        r = rows[name]
        assert (r["bytes"], r["flops"], r["peak_flops"]) == (
            case.bytes, case.flops, peak)
    assert rows["rbf_gram"]["bytes"] == 4 * (M * d + M * M)
    assert rows["rbf_gram"]["flops"] == M * (M + 1) / 2 * (2 * d + 4)
    assert rows["nystrom_recon"]["bytes"] == 4 * (Q * M + M + Q * Q)
    assert rows["nystrom_recon"]["flops"] == 3 * Q * (Q + 1) * M
    assert rows["eigvec_rotate"]["peak_flops"] == 67e12


# csrc/rbf_gram.cu's cells: float32 32 x 32, float64 64 x 64.
GRAM_CELLS = {torch.float32: 32, torch.float64: 64}


def _gram_cell_of(b, m, sym, cell):
    """(I, J) of block b: the kernel's ``cell_of``."""
    nc = -(-m // cell)
    if not sym:
        return divmod(b, nc)
    i, cnt = 0, nc
    while b >= cnt:
        b, cnt, i = b - cnt, cnt - 1, i + 1
    return i, i + b


def _gram_thread_entries(dtype):
    """(rows, cols) in the cell of the entries the block's threads hold:
    float32 thread (tx, ty) rows ty + 16 i, columns tx + 8 j; float64 warp
    w's two m16n8 fragments at rows 16 (w % 4) .., columns 16 (w // 4) ..,
    lane (g, t) rows g + 8 h, columns 8 j + 2 t + e."""
    if dtype == torch.float32:
        tx, ty, i, j = torch.meshgrid(torch.arange(8), torch.arange(16),
                                      torch.arange(2), torch.arange(4),
                                      indexing="ij")
        return (ty + 16 * i).flatten(), (tx + 8 * j).flatten()
    w, g, t, j, h, e = torch.meshgrid(
        torch.arange(16), torch.arange(8), torch.arange(4), torch.arange(2),
        torch.arange(2), torch.arange(2), indexing="ij")
    return ((16 * (w % 4) + g + 8 * h).flatten(),
            (16 * (w // 4) + 8 * j + 2 * t + e).flatten())


def _gram_cells(m, sym, cell, blocks):
    """(I, J) of every block of the launch, as tensors: the triangle's
    cells in row-major order where sym (what ``cell_of`` walks), else
    every cell."""
    nc = -(-m // cell)
    if not sym:
        return torch.arange(blocks) // nc, torch.arange(blocks) % nc
    I, J = torch.triu_indices(nc, nc)
    return I, J


def _gram_writes(n, m, sym, dtype, I, J):
    """(rows, cols) of G that the blocks of cells (I, J) write, direct then
    mirrored, as the kernel's stores mask them: a diagonal cell keeps the
    entries on and above its diagonal and mirrors those above it (float32
    through the transposed tile, float64 pair by pair), any other cell
    writes every entry inside (n, m) and, where sym, its mirror."""
    cell = GRAM_CELLS[dtype]
    rl, cl = _gram_thread_entries(dtype)
    r = I[:, None] * cell + rl[None, :]
    c = J[:, None] * cell + cl[None, :]
    inside = (r < n) & (c < m)
    diag = (I == J)[:, None] if sym else torch.zeros_like(inside)
    direct = inside & (~diag | (cl >= rl)[None, :])
    rows, cols = [r[direct]], [c[direct]]
    if sym:
        mirror = inside & (~diag | (cl > rl)[None, :])
        rows.append(c[mirror])
        cols.append(r[mirror])
    return torch.cat(rows), torch.cat(cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,m,sym", [
    (1, 1, True), (63, 63, True), (64, 64, True), (65, 65, True),
    (1024, 1024, True), (4096, 4096, True),
    (1, 1, False), (65, 63, False), (1000, 300, False), (130, 129, False)])
def test_rbf_gram_cells_write_each_entry_once(n, m, sym, dtype):
    """A mirror of the kernels' walk over their cells: where y is x the
    triangle's cells (528 blocks at n = 1024 in float32, 136 in float64,
    where the square takes 1024 and 256), each entry written with its
    mirror, cover every entry of G exactly once, counting mirrors, and
    nothing outside (n, m); otherwise every cell, no mirror.  The threads'
    entries cover a cell once.  All blocks' writes are built as tensors in
    one pass; the cells are those of the kernel's block-to-cell map."""
    cell = GRAM_CELLS[dtype]
    nc = -(-m // cell)
    blocks = nc * (nc + 1) // 2 if sym else -(-n // cell) * nc
    assert n != 1024 or blocks == {32: 528, 64: 136}[cell]
    I, J = _gram_cells(m, sym, cell, blocks)
    assert list(zip(I.tolist(), J.tolist())) == [
        _gram_cell_of(b, m, sym, cell) for b in range(blocks)]
    assert len(set(zip(I.tolist(), J.tolist()))) == blocks
    assert not sym or bool((J >= I).all())
    rl, cl = _gram_thread_entries(dtype)
    cover = torch.zeros((cell, cell), dtype=torch.int32)
    cover.index_put_((rl, cl), torch.ones_like(rl, dtype=torch.int32),
                     accumulate=True)
    assert torch.all(cover == 1)
    r, c = _gram_writes(n, m, sym, dtype, I, J)
    width = m + cell
    counts = torch.bincount(r * width + c, minlength=(n + cell) * width)
    counts = counts.reshape(n + cell, width)
    assert torch.all(counts[:n, :m] == 1)
    assert int(counts.sum()) == n * m


def _f64_row_blocks(monkeypatch):
    """The row-block wrappers evaluated in float64 on the CPU."""
    monkeypatch.setattr(eops, "rotate_vectors", _in_f64(
        lambda u, z, d, lam, inv, m, *, tau, row_offset=None:
        eref.eigvec_rotate_ref(u, z, d, lam, inv, tau, m, row_offset)))
    monkeypatch.setattr(eops, "rotate_vectors2", _in_f64(
        lambda u, *ops, tau1, tau2, row_offset=None: eref.eigvec_rotate2_ref(
            u, *ops, row_offset, tau1=tau1, tau2=tau2)))
    monkeypatch.setattr(eops, "project_vectors", _in_f64(
        lambda u, v, m, *, row_offset=None: eref.eigvec_project_ref(
            u, v, m, row_offset)))
    monkeypatch.setattr(kops, "krow_project", _in_f64(
        lambda u, x, xq, aux, m, *, spec, row_offset=None: krow_project_ref(
            u, x, xq, aux, m, row_offset, spec=spec)))
    monkeypatch.setattr(nops, "transform_project",
                        _in_f64(transform_project_ref))


@pytest.mark.parametrize("m", [1, 30, 64, 90, N])
@pytest.mark.parametrize("name", ["eigvec_rotate", "eigvec_rotate2",
                                  "eigvec_project", "krow_project"])
def test_row_block_cases_pass_a_more_accurate_evaluation(monkeypatch, name,
                                                         m):
    """The row-block cases (rows N/4 .. 3N/4): a float64 evaluation of the
    same function on the block passes each entry's bound and writes the
    pruned rows and columns as exact zeros, also where m falls before the
    block (m = 1) or inside it."""
    _f64_row_blocks(monkeypatch)
    case = next(c for c in checks.cases(N, m, torch.float32, "cpu")
                if c.name == name and c.variant)
    assert case.variant == f"rows {N // 4}:{N // 4 + N // 2}"
    res = checks.compare(case)
    assert 0.0 <= res["max_err_over_tol"] <= 1.0


@pytest.mark.parametrize("m", [1, 30, 64, 90])
def test_rotate2_block_past_m_is_zeros(monkeypatch, m):
    """The fused pair on rows m .. N, wholly past the active rows: the
    case exists for every m < N, its float64 evaluation passes, and every
    entry must be an exact zero (``compare`` refuses a tiny nonzero)."""
    _f64_row_blocks(monkeypatch)
    case = next(c for c in checks.cases(N, m, torch.float32, "cpu")
                if (c.name, c.variant) == ("eigvec_rotate2", f"rows {m}:{N}"))
    checks.compare(case)
    (C,) = case.kernel()
    assert C.shape == (N - m, N) and torch.all(C == 0)

    def kernel():
        (C,) = case.kernel()
        C = C.clone()
        C[0, 0] = 1e-30
        return (C,)

    with pytest.raises(AssertionError):
        checks.compare(dataclasses.replace(case, kernel=kernel))


VARIANTS = [("krow_project", "naux 0"), ("transform_project", "C 20"),
            ("transform_project", "Q 512, C 64"), ("transform_project", "C 1"),
            ("transform_project", f"C {N}, features")]


def _variant(name, variant, m, dtype=torch.float32):
    if variant.endswith("features"):
        return checks.features_case(N, m, dtype, "cpu")
    return next(c for c in checks.cases(N, m, dtype, "cpu")
                if (c.name, c.variant) == (name, variant))


@pytest.mark.parametrize("m", [1, 64, N])
@pytest.mark.parametrize("name,variant", VARIANTS)
def test_variant_cases_pass_a_more_accurate_evaluation(monkeypatch, name,
                                                       variant, m):
    """Algorithm 1's prologue (no aux columns) and the other transforms
    (20 components; the roofline's 512 queries of 64; the KRR head's one
    component; the Nyström feature head's N): a float64 evaluation passes
    each entry's bound, and the outputs have the variant's shape (C capped
    at m where the case draws the top components, all N columns for the
    feature head)."""
    _f64_row_blocks(monkeypatch)
    case = _variant(name, variant, m)
    res = checks.compare(case)
    assert 0.0 <= res["max_err_over_tol"] <= 1.0
    got = case.kernel()
    if name == "krow_project":
        assert got[1].shape == (N, 1)
    else:
        nq = 512 if "Q" in variant else 64
        C = int(variant.split("C ")[1].split(",")[0])
        C = C if variant.endswith("features") else min(C, m)
        assert got[0].shape == (nq, C) and got[1].shape == (nq,)


@pytest.mark.parametrize("name,variant", VARIANTS)
def test_variant_cases_refuse_a_wrong_column(name, variant):
    case = _variant(name, variant, 90)
    checks.compare(case)
    col = 0 if name == "krow_project" or variant == "C 1" else 13
    with pytest.raises(AssertionError, match="exceeds its bound"):
        checks.compare(_with_column(case, 1 if name == "krow_project" else 0,
                                    col, lambda c: c * (1 + 1e-3)))


@pytest.mark.parametrize("output", [0, 1])
def test_krow_pruned_outputs_must_be_exact_zeros(output):
    """``compare`` holds the k-row case to exact zeros on a's masked rows
    (output 0) and on P's rows past the live slabs (output 1): a tiny
    nonzero there is refused (those entries' bounds are 0 too), as it is
    by the exact-zero masks alone."""
    case = _case("krow_project", 40)

    def kernel():
        a, P = (o.clone() for o in case.kernel())
        (a if output == 0 else P)[-1] = 1e-30
        return a, P

    with pytest.raises(AssertionError, match="exceeds its bound"):
        checks.compare(dataclasses.replace(case, kernel=kernel))
    loose = tuple(torch.full_like(t, float("inf")) for t in case.tols)
    with pytest.raises(AssertionError, match=f"output {output}'s pruned"):
        checks.compare(dataclasses.replace(case, kernel=kernel, tols=loose))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rotate_bound_counts_its_products(dtype):
    """float32: three TF32 products, 6 m³ at 495 TFLOP/s, the bound the
    kernel's float32-accurate tensor-core product can reach; float64:
    2 m³ + m² at the type's 67 TFLOP/s.  Both operations-bound at the
    main path's bucket 1024, m = 1000."""
    case = next(c for c in checks.cases(1024, 1000, dtype, "cpu")
                if c.name == "eigvec_rotate" and not c.variant)
    ms, by = case.bound(dtype)
    if dtype == torch.float32:
        assert by == "operations, 3×TF32"
        assert ms == pytest.approx(6 * 1000 ** 3 / 495e9, rel=1e-12)
    else:
        assert by == "operations"
        assert ms == pytest.approx((2 * 1000 ** 3 + 1000 ** 2) / 67e9,
                                   rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_bound_counts_its_products(dtype):
    """float32: three TF32 products over one triangle, 3 n(n+1)k at
    495 TFLOP/s, the bound the kernel's float32-accurate tensor-core
    product can reach, and a float64 product to hold its error to;
    float64: n(n+1)k at the type's 67 TFLOP/s (0.1282 ms).  Both
    operations-bound at Fig. 2's n = 4096, k = 512."""
    n, k = 4096, 512
    case = checks.gram_cases(n, k, dtype, "cpu")[0]
    ms, by = case.bound(dtype)
    if dtype == torch.float32:
        assert by == "operations, 3×TF32"
        assert ms == pytest.approx(3 * n * (n + 1) * k / 495e9, rel=1e-12)
        assert ms == pytest.approx(0.0521, abs=5e-5)
        assert case.exact is not None
    else:
        assert by == "operations"
        assert ms == pytest.approx(n * (n + 1) * k / 67e9, rel=1e-12)
        assert ms == pytest.approx(0.1282, abs=5e-5)
        assert case.exact is None
