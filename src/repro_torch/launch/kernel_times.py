"""Device time of chosen kernels at chosen shapes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times \\
        --kpca 1024:1000:float32 256:200:float64 \\
        --flash 1:4096:64:8:128:bfloat16 --gram 4096:512:float64 \\
        --ssd 16:256:128:256:64:bfloat16 \\
        --flash-bwd 4:2048:36:36:64:bfloat16 \\
        --ssd-bwd 16:256:128:256:64:bfloat16

``--kpca n:m:dtype`` times the KPCA path's kernels named by ``--kernels``
(default ``eigvec_rotate2``) at capacity bucket n with m active pairs,
the row-block cases among them (``variant`` names their rows);
``--flash B:T:H:Hkv:hd:dtype`` times ``flash_attention``, ``--flash-bwd
B:T:H:Hkv:hd:dtype`` its backward (with ``split``: each device kernel's
ms per call, from one more profile), ``--gram
n:k:dtype`` ``scaled_gram`` (B of n rows and width k), ``--ssd
G:Q:N:H:P:dtype`` ``ssd_intra_chunk``, ``--ssd-bwd G:Q:N:H:P:dtype`` its
backward (with ``split``, as ``--flash-bwd``), ``--rbf n:m:d:dtype``
``rbf_gram`` (n = m is k(X, X)) and ``--magic`` ``rbf_gram`` on Fig. 2's
full gram (``magic_like``, 4096², d = 10, f64).  The inputs and
bounds are ``kernels/checks.py``'s.  Each row is one JSON line: the
kernel's device ms per call and device launches per call
(``checks.device_ms``: profiler records, the wrapper's own elementwise
work included), the library call's device ms, the bound and what bounds
it, and the card's name; where the case has a float64 product of its
operands, the kernel's and the plain version's largest error against it
(``checks.error_vs_exact``).  Each kernel is first checked against its
plain version.  The script reaches the kernels only through ``checks``,
so run as a file with another tree's ``src`` first on ``PYTHONPATH`` it
times that tree's kernels: two commits compared within one chip call.
"""
from __future__ import annotations

import argparse
import json
import re

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import checks


def _row(case, dtype, label: dict) -> dict:
    res = checks.compare(case)
    ms, launches = checks.device_ms(case.kernel)
    bound_ms, bound_by = case.bound(dtype)
    exact = (checks.error_vs_exact(case)
             if getattr(case, "exact", None) is not None else {})
    return {**label, "name": case.name,
            "variant": getattr(case, "variant", ""),
            "dtype": str(dtype).removeprefix("torch."), "ms": ms,
            "device_launches_per_call": launches,
            "library_ms": (checks.device_ms(case.library)[0]
                           if case.library else None),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_err_over_tol": res["max_err_over_tol"], **exact,
            "device": torch.cuda.get_device_name(0)}


def _split(fn, reps: int = 10) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches, by name, from
    one profile of ``reps`` calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::", "", e.name)
            name = name.split("(")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / (
                1e3 * reps)
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kpca", nargs="*", default=(),
                    help="n:m:dtype shapes of the KPCA kernels")
    ap.add_argument("--kernels", nargs="*", default=("eigvec_rotate2",))
    ap.add_argument("--flash", nargs="*", default=(),
                    help="B:T:H:Hkv:hd:dtype shapes of flash_attention")
    ap.add_argument("--flash-bwd", nargs="*", default=(),
                    help="B:T:H:Hkv:hd:dtype shapes of the flash_attention "
                         "backward")
    ap.add_argument("--gram", nargs="*", default=(),
                    help="n:k:dtype shapes of scaled_gram")
    ap.add_argument("--ssd", nargs="*", default=(),
                    help="G:Q:N:H:P:dtype shapes of ssd_intra_chunk")
    ap.add_argument("--ssd-bwd", nargs="*", default=(),
                    help="G:Q:N:H:P:dtype shapes of the ssd_intra_chunk "
                         "backward")
    ap.add_argument("--rbf", nargs="*", default=(),
                    help="n:m:d:dtype shapes of rbf_gram (n = m: k(X, X))")
    ap.add_argument("--magic", action="store_true",
                    help="rbf_gram on Fig. 2's full gram (magic_like, "
                         "4096 x 4096, d = 10, f64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for spec in args.kpca:
        n, m, dtype_name = spec.split(":")
        dtype = getattr(torch, dtype_name)
        for case in checks.cases(int(n), int(m), dtype, "cuda"):
            if case.name in args.kernels:
                rows.append(_row(case, dtype, {"n": int(n), "m": int(m)}))
                print(json.dumps(rows[-1]), flush=True)
    for spec in args.flash:
        *shape, dtype_name = spec.split(":")
        B, T, H, Hkv, hd = map(int, shape)
        dtype = getattr(torch, dtype_name)
        case = checks.flash_attention_case(B, T, H, Hkv, hd, dtype, "cuda")
        rows.append(_row(case, dtype, {"B": B, "T": T, "H": H, "Hkv": Hkv,
                                       "hd": hd}))
        print(json.dumps(rows[-1]), flush=True)
    for spec in args.flash_bwd:
        *shape, dtype_name = spec.split(":")
        B, T, H, Hkv, hd = map(int, shape)
        dtype = getattr(torch, dtype_name)
        case = checks.flash_attention_bwd_case(B, T, H, Hkv, hd, dtype,
                                               "cuda")
        rows.append(_row(case, dtype, {"B": B, "T": T, "H": H, "Hkv": Hkv,
                                       "hd": hd}))
        rows[-1]["split"] = _split(case.kernel)
        print(json.dumps(rows[-1]), flush=True)
    for spec in args.gram:
        n, k, dtype_name = spec.split(":")
        dtype = getattr(torch, dtype_name)
        for case in checks.gram_cases(int(n), int(k), dtype, "cuda"):
            rows.append(_row(case, dtype, {"n": int(n), "k": int(k)}))
            print(json.dumps(rows[-1]), flush=True)
    for spec in args.ssd:
        *shape, dtype_name = spec.split(":")
        G, Q, N, H, P = map(int, shape)
        dtype = getattr(torch, dtype_name)
        case = checks.ssd_intra_chunk_case(G, Q, N, H, P, dtype, "cuda")
        rows.append(_row(case, dtype, {"G": G, "Q": Q, "N": N, "H": H,
                                       "P": P}))
        print(json.dumps(rows[-1]), flush=True)
    for spec in args.ssd_bwd:
        *shape, dtype_name = spec.split(":")
        G, Q, N, H, P = map(int, shape)
        dtype = getattr(torch, dtype_name)
        case = checks.ssd_intra_chunk_bwd_case(G, Q, N, H, P, dtype, "cuda")
        rows.append(_row(case, dtype, {"G": G, "Q": Q, "N": N, "H": H,
                                       "P": P}))
        rows[-1]["split"] = _split(case.kernel)
        print(json.dumps(rows[-1]), flush=True)
    for spec in args.rbf:
        n, m, dim, dtype_name = spec.split(":")
        dtype = getattr(torch, dtype_name)
        for case in checks.rbf_gram_cases(int(n), int(m), int(dim), dtype,
                                          "cuda"):
            rows.append(_row(case, dtype, {"n": int(n), "m": int(m),
                                           "d": int(dim)}))
            print(json.dumps(rows[-1]), flush=True)
    if args.magic:
        from repro_torch.core import kernels_fn as kf
        from repro_torch.data.uci_like import load_dataset

        X = torch.as_tensor(load_dataset("magic", n=4096, seed=0),
                            device="cuda")
        case = checks.rbf_gram_case(X, X, float(kf.median_heuristic(X)))
        rows.append(_row(case, torch.float64, {"n": 4096, "m": 4096,
                                               "d": X.shape[1]}))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
