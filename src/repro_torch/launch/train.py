"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --device cpu --steps 22 --batch 4 --seq 64 \\
        --optimizer shampoo --precond-every 5

Wires config -> init on the device (or a checkpoint restore) -> the
synthetic data pipeline -> the train step (microbatch accumulation, AdamW or
Shampoo) -> the straggler monitor -> atomic asynchronous checkpoints, as
``repro.launch.train`` does on one device.  ``--device`` is ``cuda`` by
default and raises without a card; ``--device cpu`` runs the kernels'
plain twins.  ``--reduced`` is the tiny same-family config.  The
reference's ``--want-model-parallel`` comes with the next mesh slice (the
model stack sharded over the mesh, ROADMAP.md queue 1 item 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..convert import _device
from ..data import SyntheticLM
from ..models.config import reduced as reduce_cfg
from ..optim import OptConfig, ShampooConfig, state_memory_report
from ..runtime import guard, telemetry
from ..runtime.events import get_logger
from ..runtime.fault import StragglerMonitor
from ..train import TrainState, make_train_step, train_state_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config for CPU demo runs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--kron-ffn", action="store_true",
                    help="enable the paper's Kron-compressed FFN projections")
    ap.add_argument("--optimizer", choices=("adamw", "shampoo"), default="adamw",
                    help="shampoo: Kron-factored preconditioning applied "
                         "through batched KronOp shape groups")
    ap.add_argument("--precond-every", type=int, default=20,
                    help="shampoo inverse-root refresh cadence (steps)")
    ap.add_argument("--numerics", choices=list(guard.NUMERICS_POLICIES), default=None,
                    help="non-finite guard at StageProgram boundaries "
                         "(default: FASTKRON_NUMERICS or off)")
    ap.add_argument("--telemetry", metavar="OUT.jsonl", default=None,
                    help="KronScope JSONL event sink: spans, guard/chaos "
                         "events, step-latency histograms, tokens/s gauges")
    ap.add_argument("--trace", metavar="OUT.trace.json", default=None,
                    help="Chrome-trace (Perfetto) export of the host-side "
                         "spans, written at exit")
    args = ap.parse_args(argv)
    if args.numerics is not None:
        guard.set_numerics_policy(args.numerics)
    if args.telemetry or args.trace:
        telemetry.configure(jsonl=args.telemetry, trace=args.trace)
    log = get_logger("repro_torch.train")
    device = _device(args.device)
    on_card = device.type == "cuda"

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg, dtype="float32")
    if args.kron_ffn:
        cfg = dataclasses.replace(cfg, kron_ffn=True)
    opt_kw = dict(lr=args.lr, warmup_steps=max(args.steps // 20, 2), decay_steps=args.steps)
    if args.optimizer == "shampoo":
        opt_cfg: OptConfig = ShampooConfig(precond_every=args.precond_every, **opt_kw)
    else:
        opt_cfg = OptConfig(**opt_kw)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {device} ({name})")

    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       device=str(device))
    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True) if args.ckpt_dir else None

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = train_state_init(cfg, opt_cfg, gen, device=device)
    start = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        state = TrainState(**mgr.restore(state._asdict()))
        start = int(state.step)
        print(f"resumed from step {start}")

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    mon = StragglerMonitor(action="log")
    shampoo_on = isinstance(opt_cfg, ShampooConfig)
    base_step_s = None  # rolling min of non-refresh steps (see below)
    t_start = time.time()
    for i in range(start, args.steps):
        toks, labels = data.global_batch(i)
        mon.start()
        t_step = time.perf_counter()
        with telemetry.span("train_step", step=i):
            state, metrics = step_fn(state, {"tokens": toks, "labels": labels})
            sync()
        dt_step = time.perf_counter() - t_step
        telemetry.observe("train.step_seconds", dt_step)
        if shampoo_on and telemetry.active():
            telemetry.gauge_set("optim.precond_stale_steps",
                                int(metrics["precond_stale_steps"]))
            # the refresh's cost is the refresh-step excess over the
            # rolling minimum of plain steps
            opt_step = int(state.opt["step"])
            is_refresh = opt_step == 1 or opt_step % max(opt_cfg.precond_every, 1) == 0
            if not is_refresh and i > start:
                base_step_s = dt_step if base_step_s is None else min(base_step_s, dt_step)
            elif is_refresh and base_step_s is not None:
                telemetry.observe("optim.root_refresh_seconds",
                                  max(0.0, dt_step - base_step_s))
        mon.stop(i)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(
                f"step {i:5d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e}",
                flush=True,
            )
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state._asdict())
    if mgr:
        mgr.save(args.steps, state._asdict())
        mgr.wait()
    dt = time.time() - t_start
    tok_s = args.steps * args.batch * args.seq / max(dt, 1e-9)
    telemetry.gauge_set("train.tokens_per_s", tok_s)
    log.info(f"done: {args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    # Optimizer-state memory by dtype: the bf16 ``state_dtype`` saving and
    # Shampoo's kron-statistics footprint, visible at exit.
    mem = state_memory_report(state.opt)
    log.info(
        f"optimizer state: {mem['total_bytes'] / 1e6:.2f} MB "
        + " ".join(f"{k}={v / 1e6:.2f}MB" for k, v in sorted(mem["by_dtype"].items()))
    )
    # ONE merged exit report: guard health carries the telemetry snapshot
    # (counters, gauges, histogram percentiles) when KronScope is live.
    report = guard.health_report()
    report["opt_state_memory"] = mem
    if telemetry.active() or report["events"] or any(
        h["degraded_calls"] or h["errors"] for h in report["ops"].values()
    ):
        log.info(f"health: {report}")
    telemetry.shutdown()


if __name__ == "__main__":
    main()
