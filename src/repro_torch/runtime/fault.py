"""Fault-tolerance runtime: the straggler monitor.

The port of ``repro.runtime.fault``'s ``StragglerMonitor``: per-step wall-
time EWMA/EWVAR; steps beyond ``mean + k*std`` are flagged.  A persistent
straggler (flagged ``patience`` times in a row) triggers the configured
action: "log", "callback" (e.g. ask the cluster manager to reschedule) or
"raise" (fail fast so the job restarts from the last checkpoint).  The
caller times the step: on the card it synchronizes the device before
``stop``, or the monitor times the enqueue.  ``elastic_mesh`` builds the
largest ``(data, model)`` DeviceMesh over the ranks that survived.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable

from . import telemetry
from .events import get_logger


@dataclass
class StragglerMonitor:
    threshold_sigma: float = 3.0
    patience: int = 3
    alpha: float = 0.1           # EWMA decay
    action: str = "log"          # log | raise | callback
    callback: Callable[[int, float], None] | None = None
    warmup_steps: int = 5

    _mean: float = field(default=0.0, init=False)
    _var: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    _consecutive: int = field(default=0, init=False)
    flagged_steps: list = field(default_factory=list, init=False)
    _t0: float = field(default=0.0, init=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        """Record one step; returns True if flagged as straggling."""
        dt = time.perf_counter() - self._t0
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps:
            # prime with running mean / mean squared deviation
            k = self._n
            delta = dt - self._mean
            self._mean += delta / k
            self._var += ((dt - self._mean) * delta - self._var) / k
            return False
        # floor the std at 5% of the mean: healthy jitter never flags
        std = max(math.sqrt(max(self._var, 0.0)), 0.05 * self._mean, 1e-9)
        is_slow = dt > self._mean + self.threshold_sigma * std
        if is_slow:
            self._consecutive += 1
            self.flagged_steps.append((step, dt))
            telemetry.event(
                "straggler", step=step, seconds=dt, mean_seconds=self._mean
            )
            if self._consecutive >= self.patience:
                # Re-arm BEFORE acting: the action fires once per patience
                # window, not on every slow step after the first window
                # (a raise would otherwise re-raise, a reschedule callback
                # would storm the cluster manager).
                self._consecutive = 0
                msg = (
                    f"straggler: step {step} took {dt:.3f}s "
                    f"(mean {self._mean:.3f}s +{self.threshold_sigma} sigma)"
                )
                if self.action == "raise":
                    raise RuntimeError(msg)
                if self.action == "callback" and self.callback:
                    self.callback(step, dt)
                else:
                    # the shared ``repro_torch`` logger (bare-message stdout)
                    get_logger("repro_torch.fault").warning(
                        f"[straggler-monitor] {msg}"
                    )
        else:
            self._consecutive = 0
            # EWMA update only on healthy steps (stragglers don't poison it)
            self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
            delta = dt - self._mean
            self._var = (1 - self.alpha) * self._var + self.alpha * delta * delta
        return is_slow


def elastic_shape(n_devices: int, want_model: int = 16) -> tuple[int, int]:
    """``(data, model)`` of ``elastic_mesh``: model is the largest power of
    two that divides ``n_devices`` and is ``<= want_model``, data the rest,
    so every device is used."""
    model = 1
    while model * 2 <= want_model and n_devices % (model * 2) == 0:
        model *= 2
    return n_devices // model, model


def elastic_mesh(n_devices: int, *, want_model: int = 16, axis_names=("data", "model"),
                 devices=None, device_type: str | None = None):
    """Largest ``(data, model)`` DeviceMesh for however many ranks survived
    (``elastic_shape``), so a job that loses a host restarts on the N-k
    ranks left without config edits.

    Over ``torch.distributed``'s world (which must hold ``n_devices``
    ranks), or over the ranks in ``devices`` (every rank of the world
    calls it, as process groups are made collectively).  ``device_type``:
    ``"cuda"`` unless given (``"cpu"`` for a gloo mesh on the CPU).  The
    caller initialises the process group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    data, model = elastic_shape(int(n_devices), want_model)
    ranks = list(range(n_devices)) if devices is None else [int(d) for d in devices]
    if len(ranks) != n_devices:
        raise ValueError(f"{len(ranks)} ranks given for n_devices={n_devices}")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if max(ranks) >= world:
        raise RuntimeError(
            f"elastic_mesh over ranks up to {max(ranks)} needs an initialised "
            f"torch.distributed world that holds them (world size {world})"
        )
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(data, model)
    return DeviceMesh(device_type or "cuda", mesh, mesh_dim_names=tuple(axis_names))


__all__ = ["StragglerMonitor", "elastic_mesh", "elastic_shape"]
