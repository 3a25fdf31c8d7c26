"""LM prefill time and where its device time goes, on the card.

    python src/repro_torch/launch/prefill_times.py [--root DIR]

Runs the ``lm`` phase of ``chip_smoke.py`` (one period of Jamba-1.5-Large
at full width, no experts, bf16; prefill at B = 1, T = 4096, 3 warm-up and
10 timed calls, launches held to the reckoning, prefill against decode,
``serve --mode lm``) and then its profiled prefill (``lm_profile``), both
from the tree at DIR (default: the tree this file is in) with that tree's
``src``, and prints one JSON line: prefill p50 and p99 (host clock around
synchronised calls), the profiled call's device-busy ms, wall ms and idle
share, device ms by kernel group, and the card's name.  With DIR another
checkout it times that tree's prefill: two commits compared within one
chip call.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[3]),
                    help="tree whose chip_smoke.py and src are timed")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("prefill_times: needs a CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke           # puts the tree's src first on sys.path

    from repro_torch import resolve_device
    from repro_torch.kernels import checks, cuda

    resolve_device("cuda")
    cuda.library()
    with contextlib.redirect_stdout(io.StringIO()):
        lm, prefill = chip_smoke.lm_phase(torch, cuda)
        prof = chip_smoke.lm_profile_phase(checks, prefill)
    row = {"root": args.root, "prefill_ms_p50": lm["prefill_ms_p50"],
           "prefill_ms_p99": lm["prefill_ms_p99"],
           "prefill_ms": lm["prefill_ms"],
           **{k: prof[k] for k in ("device_busy_ms", "profiled_wall_ms",
                                   "idle_share", "device_ms_by_group")},
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
