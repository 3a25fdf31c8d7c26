"""End-to-end training driver — the counterpart of the reference's
``launch/train.py``, with every flag of it and ``--device``:
step-indexed data (no loader state), async atomic checkpoints and resume,
straggler heartbeats, an optional streaming-KPCA spectral monitor on the
pooled embeddings.

    python -m repro_torch.launch.train --arch minicpm_2b --steps 100 \\
        --batch 8 --seq 128                      # on the card
    python -m repro_torch.launch.train --device cpu --smoke --steps 4

One device: ``--model-axis`` takes 1 only (the mesh is ROADMAP.md §1 item
11.3).  The schedule is ``steps.schedule_for(arch, total=steps)`` at its
default peak rate, as the reference's driver takes it: ``--lr`` is parsed
and, as there, not read.  Checkpoints hold the reference's ``TrainState``
layout (``core/convert.train_state_tree``), so either package resumes the
other's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    load_checkpoint
from repro_torch.core import convert
from repro_torch.data.synthetic import TokenStream, frontend_embeddings
from repro_torch.distributed.straggler import HeartbeatMonitor
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.spectral import SpectralMonitor


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--monitor-spectra", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> tuple[dict, steps_lib.TrainState]:
    """Run the driver; returns (the reference's result dict, the final
    ``TrainState``)."""
    if args.model_axis != 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: the port trains on one device; "
            f"the model mesh is ROADMAP.md §1 item 11.3")
    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    optimizer = steps_lib.optimizer_for(args.arch)
    schedule = steps_lib.schedule_for(args.arch, total=args.steps)
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    monitor = (SpectralMonitor(capacity=96, device=dev)
               if args.monitor_spectra else None)
    hb = HeartbeatMonitor(n_workers=1, timeout_s=300.0)
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    state = steps_lib.init_train_state(cfg, optimizer, args.seed, dev)
    start = 0
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            target = convert.train_state_tree(state, cfg)
            state = convert.train_state_from_numpy(
                load_checkpoint(args.ckpt_dir, last, target), cfg, dev)
            start = last
            print(f"resumed from step {last}")

    step_fn = steps_lib.make_train_step(cfg, optimizer, schedule,
                                        accum=args.accum)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = frontend_embeddings(cfg, stream.batch_at(step, dev))
        state, metrics = step_fn(state, batch)
        hb.beat(0, step)
        if monitor is not None and step % 20 == 0:
            with torch.no_grad():
                h = lm.embed_tokens(state.params, cfg, batch["tokens"],
                                    batch.get("embeddings"))
                monitor.observe(h.float().mean(dim=1))   # (B, d) pooled
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            extra = ""
            if monitor is not None and monitor.history:
                extra = (" eff_rank="
                         f"{monitor.history[-1]['effective_rank']:.1f}")
            print(f"step {step:5d} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f}"
                  f"{extra}", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, convert.train_state_tree(state, cfg))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    if ckpt:
        ckpt.close()
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": args.steps, "wall_s": wall,
              "stragglers": hb.report()}
    print(f"done: {result}")
    return result, state


def main(argv=None) -> dict:
    return train(parse_args(argv))[0]


if __name__ == "__main__":
    main()
