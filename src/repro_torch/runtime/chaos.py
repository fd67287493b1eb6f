"""Deterministic, seeded fault injection for the Kron-Matmul spine.

The port of ``repro.runtime.chaos``, with the reference's site names and
spec format, so spec strings written for the reference work here.  Tests
(and operators) force failures at named **sites** inside the execution path
so every degradation rung in ``repro_torch.runtime.guard`` is exercised on
purpose instead of by accident:

=================  ========================================================
site               where ``maybe_fail`` is called in the port
=================  ========================================================
``pallas_lowering``  ``kernels/emit.py`` ``run_stage``/``run_stage_grad``,
                     just before a CUDA kernel's launch (the port's
                     counterpart of building a Pallas chain)
``stage_execute``    ``kernels/emit.py`` ``run_stage``/``run_stage_grad``
``per_factor``       ``core/engine.py`` per-factor rung of the ladder
``plan_cache_load``  ``core/autotune.py`` ``load_plan_cache``
``plan_cache_save``  ``core/autotune.py`` ``save_plan_cache``, each attempt
``root_refresh``     ``optim/shampoo.py`` inverse-root refresh, once per
                     eligible leaf on every refresh step (the reference's
                     fires once, when its jitted step is traced)
=================  ========================================================

The other sites of the table (``round_chain``, ``collective``,
``slab_collective``, ``serve_admit``) parse and fire as in the reference;
the port calls them from the modules later slices bring.

Activation is layered: ``inject(spec)`` pushes a parsed spec onto a stack
for a ``with`` block; the ``FASTKRON_CHAOS`` env var forms a base layer
read at import.  A spec string is a comma list of clauses::

    site[:key=value]*          e.g.  "stage_execute"
                                     "collective:p=0.5:seed=7"
                                     "plan_cache_save:times=2,round_chain"

Keys: ``p`` (firing probability, default 1.0), ``seed`` (determinism,
default 0), ``times`` (fire at most N times, default unlimited), ``after``
(skip the first N eligible hits, default 0).  Firing for ``p < 1`` is a
pure function of ``(seed, site, hit-index)``, so a given spec replays
identically run to run.

When no spec is active ``maybe_fail`` is a single truthiness check.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
from contextlib import contextmanager

from . import guard, telemetry

# site -> error type raised when the site fires
SITE_ERRORS = {
    "pallas_lowering": guard.LoweringError,
    "stage_execute": guard.VmemOverflowError,
    "per_factor": guard.VmemOverflowError,
    "round_chain": guard.VmemOverflowError,
    "collective": guard.CollectiveError,
    # Slab pipeline: fires per slab relocation when a round is slab-
    # pipelined (n_slabs > 1) — the guard ladder must degrade slabbed →
    # serial rounds → local, never corrupt the round schedule.
    "slab_collective": guard.CollectiveError,
    # Serving: fires inside the engine's bucketed prefill, before a group
    # is admitted to decode slots — the guard ladder must degrade to a
    # smaller prefill chunk, never drop the request (docs/serving.md).
    "serve_admit": guard.VmemOverflowError,
    # Optimizer: fires inside the Shampoo inverse-root refresh — the
    # affected layers must degrade to grafted AdamW for the interval, never
    # crash the training step (docs/optim.md).
    "root_refresh": guard.NumericsError,
    "plan_cache_load": guard.PlanCacheError,
    "plan_cache_save": guard.PlanCacheError,
}


@dataclasses.dataclass
class ChaosSpec:
    """One injection clause: fire ``site`` with probability ``p``."""

    site: str
    p: float = 1.0
    seed: int = 0
    times: int | None = None  # max firings; None = unlimited
    after: int = 0            # skip this many eligible hits first
    seen: int = 0             # eligible hits observed (mutates)
    fired: int = 0            # actual failures raised (mutates)

    def should_fire(self) -> bool:
        idx = self.seen
        self.seen += 1
        if idx < self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p >= 1.0:
            fire = True
        else:
            # deterministic per (seed, site, hit-index): replays identically
            # (str seeds hash stably across processes, unlike tuples)
            rng = random.Random(f"{self.seed}:{self.site}:{idx}")
            fire = rng.random() < self.p
        if fire:
            self.fired += 1
        return fire


def parse_spec(text: str) -> list[ChaosSpec]:
    """Parse a ``FASTKRON_CHAOS``-style spec string (format in moduledoc)."""
    specs: list[ChaosSpec] = []
    for clause in text.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        site = parts[0].strip()
        if site not in SITE_ERRORS:
            raise guard.PlanError(
                f"unknown chaos site {site!r}: want one of "
                f"{sorted(SITE_ERRORS)}"
            )
        kwargs: dict = {}
        for kv in parts[1:]:
            if "=" not in kv:
                raise guard.PlanError(f"bad chaos clause {clause!r}: {kv!r}")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k == "p":
                kwargs[k] = float(v)
            elif k in ("seed", "times", "after"):
                kwargs[k] = int(v)
            else:
                raise guard.PlanError(
                    f"unknown chaos key {k!r} in clause {clause!r}"
                )
        specs.append(ChaosSpec(site=site, **kwargs))
    return specs


_LOCK = threading.Lock()
_ACTIVE: list[list[ChaosSpec]] = []


def _env_layer() -> list[ChaosSpec]:
    text = os.environ.get("FASTKRON_CHAOS", "")
    return parse_spec(text) if text else []


_ENV: list[ChaosSpec] = _env_layer()


def reload_env() -> list[ChaosSpec]:
    """Re-read ``FASTKRON_CHAOS`` (tests that mutate the env after import)."""
    global _ENV
    _ENV = _env_layer()
    return _ENV


@contextmanager
def inject(spec: str | list[ChaosSpec]):
    """Activate a chaos spec for the dynamic extent of the ``with`` block.

    Yields the parsed ``ChaosSpec`` list so callers can inspect ``seen`` /
    ``fired`` counters afterwards.  Layers stack: nested ``inject`` blocks
    are all consulted.
    """
    specs = parse_spec(spec) if isinstance(spec, str) else list(spec)
    with _LOCK:
        _ACTIVE.append(specs)
    try:
        yield specs
    finally:
        with _LOCK:
            _ACTIVE.remove(specs)


def active() -> bool:
    """True when any injection layer (env or ``inject``) is live."""
    return bool(_ACTIVE) or bool(_ENV)


def maybe_fail(site: str) -> None:
    """Raise the site's typed error if an active spec says so.  No-op (one
    truthiness check) when no chaos is active."""
    if not _ACTIVE and not _ENV:
        return
    for layer in list(_ACTIVE) + ([_ENV] if _ENV else []):
        for spec in layer:
            if spec.site == site and spec.should_fire():
                telemetry.event("chaos_injected", site=site, fired=spec.fired)
                raise SITE_ERRORS[site](
                    f"chaos-injected fault at site {site!r} "
                    f"(firing {spec.fired}/{spec.times or 'inf'})"
                )


__all__ = [
    "ChaosSpec",
    "SITE_ERRORS",
    "parse_spec",
    "inject",
    "active",
    "maybe_fail",
    "reload_env",
]
