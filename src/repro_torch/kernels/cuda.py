"""Build, load and launch the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
on first use (never at import: the CPU has no ``nvcc``) into ``build/`` at
the repository root, in a directory keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``launch`` raises on anything but 0 and
counts the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("errors.cu", "eigvec_rotate.cu", "eigvec_rotate2.cu",
           "eigvec_project.cu", "krow_project.cu", "transform_project.cu",
           "scaled_gram.cu", "rbf_gram.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signature of each entry point (the _f32/_f64 pair share one).
SIGNATURES = {
    "eigvec_rotate": (P, P, P, P, P, P, P, P, I, F, P),
    "eigvec_rotate2": (P,) * 16 + (I, F, P),
    "eigvec_project": (P, P, P, P, I, I, P),
    "krow_project": (P, P, P, P, P, P, P, I, I, I, I, F, F, P),
    "transform_project": (P, P, P, P, P, P, I, I, I, I, I, F, F, P),
    "scaled_gram": (P, P, P, I, I, P),
    "rbf_gram": (P, P, P, I, I, I, F, P),
}

# Launches per kernel since the last ``reset_launches`` — a plain count,
# incremented only where a kernel is launched.
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                       "the CUDA toolkit (nvcc on PATH or in "
                       "/usr/local/cuda/bin)")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def build() -> dict:
    """Compile the library if it is not built yet; returns the seconds
    spent and each source's ``ptxas -v`` report (registers, spills)."""
    out = _build_dir()
    so = out / "librepro_torch_kernels.so"
    if so.exists():
        return {"seconds": 0.0, "cached": True, "dir": str(out)}
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        obj = out / (Path(name).stem + ".o")
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports, failed = {}, []
    for name, proc in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out / f"{so.name}.{os.getpid()}.tmp"
    objs = [str(out / (Path(n).stem + ".o")) for n in SOURCES]
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", str(tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    return {"seconds": time.perf_counter() - t0, "cached": False,
            "dir": str(out), "ptxas": reports}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_build_dir() / "librepro_torch_kernels.so"))
        for name, args in SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_operands(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every operand is a contiguous CUDA tensor of one float
    type (f32 or f64) on one device; returns that type."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: CUDA kernel takes float32 or float64, "
                        f"got {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must all lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed operand types {t.dtype} and "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return dtype


def active_count(m, device: torch.device) -> torch.Tensor:
    """The active count as the 0-d int32 device tensor the kernels read by
    pointer (no copy when it already is one)."""
    m = torch.as_tensor(m, dtype=torch.int32, device=device)
    if m.dim() != 0:
        raise ValueError(f"active count must be a scalar, got {m.shape}")
    return m


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Call ``name``'s C entry point for ``dtype`` on the current stream;
    tensors pass as pointers.  Raises if the launch was refused."""
    lib = library()
    fn = getattr(lib, name + ("_f32" if dtype == torch.float32 else "_f64"))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1
