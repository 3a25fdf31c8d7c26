"""The port stands alone: it imports neither ``jax`` nor anything of the
reference package, and nothing in it catches an exception (so no kernel
build or launch can fall back quietly)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_reference():
    modules = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                              .parts).removesuffix(".__init__")
                     for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [k for k in sys.modules if k == 'jax' or "
              "k.startswith('jax.') or k == 'repro' or "
              "k.startswith('repro.')]\n"
              "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_the_slice_modules_are_covered():
    """The modules of each slice are among the files checked here."""
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    for rel in ("core/rankone.py", "core/nystrom.py", "core/convert.py",
                "data/uci_like.py", "kernels/nystrom_recon/ops.py",
                "kernels/eigvec_update/ops.py", "launch/serve.py",
                "models/config.py", "models/layers.py", "models/ssm.py",
                "models/lm.py", "configs/__init__.py",
                "configs/jamba_1_5_large_398b.py", "launch/steps.py",
                "data/synthetic.py", "kernels/flash_attn/ops.py",
                "kernels/flash_attn/ref.py", "kernels/ssd_chunk/ops.py",
                "kernels/ssd_chunk/ref.py", "core/health.py",
                "core/telemetry.py", "testing/faults.py",
                "checkpoint/npz_store.py", "obs/hub.py", "obs/export.py",
                "obs/trace.py", "spectral/monitor.py",
                "core/distributed.py", "core/batch.py", "configs/paper.py",
                "testing/spmd.py", "models/moe.py", "models/xlstm.py",
                "configs/dbrx_132b.py", "configs/xlstm_125m.py",
                "configs/kimi_k2_1t_a32b.py"):
        assert rel in names, rel


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_source_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text())
    for name in _imports(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_source_catches_no_exception(path):
    tree = ast.parse(path.read_text())
    handlers = [n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.ExceptHandler)]
    assert not handlers, f"{path}: except at lines {handlers}"
