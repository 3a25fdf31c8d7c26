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
counts the launch.  The five kernels of the KPCA path take a tenant count
``nb``: one launch serves nb tenants whose operands lie one after another
(a leading tenant axis), the counterpart of the reference's ``pallas_call``
under ``jax.vmap``; a single call is nb = 1.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("errors.cu", "eigvec_rotate.cu", "eigvec_rotate2.cu",
           "eigvec_project.cu", "krow_project.cu", "transform_project.cu",
           "scaled_gram.cu", "rbf_gram.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "ssd_intra_chunk.cu")
HEADERS = ("common.cuh", "hopper.cuh", "rotate_tile.cuh", "project_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signature of each entry point (its typed variants share one).
SIGNATURES = {
    "eigvec_rotate": (P,) * 9 + (I,) * 5 + (F, P),
    "eigvec_rotate2": (P,) * 18 + (I,) * 4 + (F, P),
    "eigvec_project": (P, P, P, P) + (I,) * 5 + (P,),
    "krow_project": (P,) * 7 + (I,) * 9 + (F, F, P),
    "transform_project": (P,) * 6 + (I,) * 5 + (F, F) + (I,) * 7 + (P,),
    "scaled_gram": (P, P, P, P, I, I, P),
    "rbf_gram": (P, P, P, I, I, I, F, I, P),
    "flash_attention": (P, P, P, P, I, I, I, I, I, F, P),
    "flash_attention_bwd": (P,) * 10 + (I,) * 5 + (F, P),
    "ssd_intra_chunk": (P, P, P, P, P, I, I, I, I, I, P),
}
# The typed variants of each entry point, by the operands' type; the LM
# kernels take float32 and bfloat16, the others float32 and float64.
SUFFIXES = {torch.float32: "_f32", torch.float64: "_f64",
            torch.bfloat16: "_bf16"}
TYPES = {name: (torch.float32, torch.float64) for name in SIGNATURES}
TYPES.update(flash_attention=(torch.float32, torch.bfloat16),
             flash_attention_bwd=(torch.float32, torch.bfloat16),
             ssd_intra_chunk=(torch.float32, torch.bfloat16))

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


def sass_counts() -> dict:
    """Per kernel of the built library, how many tensor-core instructions
    its SASS holds (``cuobjdump -sass``): HGMMA is a wgmma, DMMA a float64
    tensor-core product.  Keys are the kernels' demangled names without
    their parameter lists."""
    ops = ("HGMMA", "DMMA")
    so = _build_dir() / "librepro_torch_kernels.so"
    tools = Path(_nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            counts[name] = dict.fromkeys(ops, 0)
        elif name:
            for op in ops:
                counts[name][op] += len(re.findall(rf"\b{op}\b", line))
    names = list(counts)
    filt = tools / "cu++filt"
    if filt.exists() and names:
        out = subprocess.run([str(filt)], input="\n".join(names),
                             capture_output=True, text=True).stdout
        plain = out.splitlines()
        if len(plain) == len(names):
            names = [re.sub(r"\((?:int|bool)\)|\(anonymous namespace\)::|"
                            r"<unnamed>::", "", p)
                     .removeprefix("void ").split("(")[0] for p in plain]
    return dict(zip(names, counts.values()))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_build_dir() / "librepro_torch_kernels.so"))
        for name, args in SIGNATURES.items():
            for dtype in TYPES[name]:
                fn = getattr(lib, name + SUFFIXES[dtype])
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# Kernels with a gradient (a backward kernel bound as a
# ``torch.autograd.Function``); every other kernel refuses operands that
# ask for one, naming where its backward is queued.
DIFFERENTIABLE = ("flash_attention", "flash_attention_bwd")
NO_BACKWARD = {"ssd_intra_chunk": "ROADMAP.md §1 item 11.4 (the "
                                  "ssd_intra_chunk backward, to train the "
                                  "Mamba family on the card)"}
KPCA_NO_BACKWARD = ("ROADMAP.md §1 item 12 (gradients through the KPCA "
                    "kernels; no path differentiates the streaming update)")


def check_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and an operand
    requires a gradient that ``name``'s kernel cannot give: its output
    would carry none, silently."""
    if name in DIFFERENTIABLE or not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward, so its output would "
            f"carry no gradient; run it without grad or see "
            f"{NO_BACKWARD.get(name, KPCA_NO_BACKWARD)}")


def check_operands(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every operand is a contiguous CUDA tensor of one float
    type that ``name`` takes (``TYPES``) on one device; returns that
    type.  A kernel without a backward also refuses operands that require
    a gradient while grad mode is on (``check_grad``)."""
    check_grad(name, *tensors)
    dtype = tensors[0].dtype
    if dtype not in TYPES[name]:
        raise TypeError(f"{name}: CUDA kernel takes "
                        f"{' or '.join(map(str, TYPES[name]))}, got {dtype}")
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


def active_count(m, device: torch.device,
                 tenants: int | None = None) -> torch.Tensor:
    """The active count as the int32 device tensor the kernels read by
    pointer (no copy when it already is one): 0-d for a single call, or
    (tenants,) per tenant for a call over a leading tenant axis."""
    m = torch.as_tensor(m, dtype=torch.int32, device=device)
    want = () if tenants is None else (tenants,)
    if m.shape != want:
        raise ValueError(f"active count must have shape {want}, got "
                         f"{tuple(m.shape)}")
    return m.contiguous()


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Call ``name``'s C entry point for ``dtype`` on the current stream;
    tensors pass as pointers.  Raises if the launch was refused."""
    lib = library()
    fn = getattr(lib, name + SUFFIXES[dtype])
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1
