"""Execution guard layer: error taxonomy, degradation ladder, numerics guards.

The port of ``repro.runtime.guard``, with the same names and bases, so
``except`` clauses and spec strings written against the JAX package carry
over.  Three pieces:

* **Error taxonomy** — ``KronError`` and its typed subclasses; each also
  derives from the builtin type callers used to catch (``VmemOverflowError``
  is a ``ValueError``, ``PlanCacheError`` an ``OSError``, ...).  "VMEM" in
  ``VmemOverflowError`` means the on-chip budget of one block: shared memory
  on the card.

* **Degradation ladder + circuit breaker** — ``run_ladder`` executes a
  sequence of rungs (for a ``KronOp``: the planned program -> one kernel per
  factor -> the plain twins, the last only on the ``torch`` backend) with
  per-key health state: the first failure degrades THE CALL with a
  once-per-process warning; ``patience`` consecutive degraded calls PIN the
  key to the degraded rung so later calls skip the failing rung.  Counters
  are exposed via ``health_report()`` and surfaced by ``KronOp.describe()``.
  Health is process-local state, read and written on the host at each call.

* **Numerics guards** — ``check_finite`` instruments the ``StageProgram``
  boundary with policy ``off | warn | raise`` (``FASTKRON_NUMERICS``, read
  at import and by ``set_numerics_policy(None)``, or
  ``set_numerics_policy``).  ``off`` is a single string compare and adds no
  host synchronisation; ``warn`` and ``raise`` reduce ``torch.isfinite`` on
  the tensor's device and read the flag on the host, which waits for the
  device to finish the work queued before it.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import warnings
from typing import Callable, Sequence

import torch

from . import telemetry


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class KronError(Exception):
    """Base of every typed Kron-Matmul runtime error."""


class PlanError(KronError, ValueError):
    """Planning failed: invalid plan inputs or an unknown tune mode."""


class VmemOverflowError(KronError, ValueError):
    """A kernel tile's live set exceeds the on-chip budget of one block.
    The signal the degradation ladder and the per-factor fallbacks key on."""


class LoweringError(KronError, ValueError):
    """A stage cannot be lowered to the kernel: illegal tiling,
    non-dividing dims, an unsupported dtype, or a malformed instruction."""


class CollectiveError(KronError, RuntimeError):
    """A distributed relocation round failed (or was chaos-injected to
    fail).  The mesh ladder degrades to local execution."""


class PlanCacheError(KronError, OSError):
    """Plan-cache IO failed: corrupt entry, lock/rename contention, or an
    injected fault.  Always degraded (warn + rebuild/retry), never fatal."""


class NumericsError(KronError, FloatingPointError):
    """A non-finite value crossed a guarded StageProgram boundary under
    policy ``raise``."""


class GuardWarning(UserWarning):
    """Warning category for every degradation the guard layer performs."""


# ---------------------------------------------------------------------------
# Once-per-process warning bookkeeping
# ---------------------------------------------------------------------------

_WARNED: set = set()
_LOCK = threading.Lock()


def warn_once(token, message: str) -> None:
    """Emit ``GuardWarning`` once per process per ``token``."""
    with _LOCK:
        if token in _WARNED:
            return
        _WARNED.add(token)
    telemetry.event("guard_warning", token=str(token), message=message)
    warnings.warn(message, GuardWarning, stacklevel=3)


_DEPRECATED: set[str] = set()


def warn_deprecated_once(name: str, message: str) -> None:
    """Emit ``DeprecationWarning`` once per process per legacy entry point
    ``name``, pointing at the caller of the entry point (which calls this
    through one helper of its own: ``ops.warn_shim``,
    ``engine.warn_deprecated``)."""
    with _LOCK:
        if name in _DEPRECATED:
            return
        _DEPRECATED.add(name)
    warnings.warn(message, DeprecationWarning, stacklevel=4)


# ---------------------------------------------------------------------------
# Health state (circuit breaker)
# ---------------------------------------------------------------------------

DEFAULT_PATIENCE = 3


@dataclasses.dataclass
class OpHealth:
    """Mutable per-key circuit-breaker state (see ``run_ladder``)."""

    rung: int = 0            # rung calls currently START at
    pinned: bool = False     # True once patience pinned the key to ``rung``
    calls: int = 0
    degraded_calls: int = 0  # calls that completed below their start rung
    consecutive: int = 0     # consecutive calls that had to degrade
    errors: dict = dataclasses.field(default_factory=dict)  # type name -> n
    last_error: str | None = None

    def record(self, exc: BaseException) -> None:
        name = type(exc).__name__
        self.errors[name] = self.errors.get(name, 0) + 1
        self.last_error = f"{name}: {exc}"

    def summary(self) -> dict:
        return {
            "rung": self.rung,
            "pinned": self.pinned,
            "calls": self.calls,
            "degraded_calls": self.degraded_calls,
            "errors": dict(self.errors),
            "last_error": self.last_error,
        }


_HEALTH: dict = {}
_EVENTS: dict = {}  # free-form degradation counters (backward fallbacks, ...)


def health(key) -> OpHealth:
    """Get-or-create the circuit-breaker state for ``key``."""
    h = _HEALTH.get(key)
    if h is None:
        h = _HEALTH[key] = OpHealth()
    return h


def health_entries():
    """Raw (key, OpHealth) items, for callers that filter by key structure
    (``KronOp.describe`` matches its own signature)."""
    return list(_HEALTH.items())


def record_event(name: str, exc: BaseException | None = None) -> None:
    """Count a degradation event outside any ladder (a stage backward that
    took the per-factor fallback, a non-finite value, ...).  Active
    telemetry receives the same event on its sink."""
    _EVENTS[name] = _EVENTS.get(name, 0) + 1
    if exc is not None:
        ename = f"{name}:{type(exc).__name__}"
        _EVENTS[ename] = _EVENTS.get(ename, 0) + 1
        telemetry.event(name, error=type(exc).__name__, detail=str(exc))
    else:
        telemetry.event(name)


def health_report() -> dict:
    """Snapshot of every guarded key's counters plus free-form event counts.

    ``{"ops": {str(key): summary_dict}, "events": {name: count}}`` — the
    process-wide answer to "has anything degraded, and why".  While
    telemetry is active a ``"telemetry"`` key carries its ``snapshot()``.
    """
    report = {
        "ops": {repr(k): h.summary() for k, h in _HEALTH.items()},
        "events": dict(_EVENTS),
    }
    if telemetry.active():
        report["telemetry"] = telemetry.snapshot()
    return report


def reset_health() -> None:
    """Clear all health state and once-per-process warning tokens."""
    _HEALTH.clear()
    _EVENTS.clear()
    with _LOCK:
        _WARNED.clear()


# ---------------------------------------------------------------------------
# The degradation ladder
# ---------------------------------------------------------------------------


def run_ladder(
    key,
    rungs: Sequence[tuple[str, Callable[[], object]]],
    *,
    patience: int = DEFAULT_PATIENCE,
    catch: tuple = (KronError,),
):
    """Execute ``rungs`` (ordered most- to least-performant) under the
    circuit breaker keyed by ``key``.

    Starts at the key's current rung; a ``catch``-matching failure records
    the typed error, warns once per process, and falls through to the next
    rung.  A call that completes below its start rung counts as degraded;
    ``patience`` consecutive degraded calls pin the key to the completing
    rung (later calls skip the failing rung without retrying it).  A call
    that completes at its start rung resets the consecutive counter.  If
    every rung fails the LAST error is re-raised — the ladder never
    swallows a total failure.
    """
    h = health(key)
    h.calls += 1
    start = h.rung
    last_exc = None
    for i in range(start, len(rungs)):
        name, fn = rungs[i]
        try:
            out = fn()
        except catch as e:  # typed failures only: real bugs propagate
            h.record(e)
            last_exc = e
            telemetry.event(
                "rung_fallback", key=repr(key), rung=i, rung_name=name,
                error=type(e).__name__,
            )
            if i + 1 < len(rungs):
                warn_once(
                    (key, i),
                    f"kron guard: {key} failed on rung {i} ({name}): "
                    f"{type(e).__name__}: {e} — degrading to rung {i + 1} "
                    f"({rungs[i + 1][0]})",
                )
            continue
        if i > start:
            h.degraded_calls += 1
            h.consecutive += 1
            if h.consecutive >= patience:
                h.rung = i
                h.pinned = True
                h.consecutive = 0
                telemetry.event(
                    "rung_pinned", key=repr(key), rung=i, rung_name=name
                )
                warn_once(
                    (key, "pinned", i),
                    f"kron guard: {key} degraded {patience} consecutive "
                    f"calls — pinned to rung {i} ({name})",
                )
        else:
            h.consecutive = 0
        return out
    assert last_exc is not None  # a key's rung is always one that completed
    raise last_exc


# ---------------------------------------------------------------------------
# Numerics guards (StageProgram boundary)
# ---------------------------------------------------------------------------

NUMERICS_POLICIES = ("off", "warn", "raise")


def _env_policy() -> str:
    env = os.environ.get("FASTKRON_NUMERICS", "off")
    return env if env in NUMERICS_POLICIES else "off"


# Read once here and on ``set_numerics_policy(None)``, not on every call.
_numerics_policy: str = _env_policy()


def numerics_policy() -> str:
    """The active non-finite-guard policy: ``off`` | ``warn`` | ``raise``."""
    return _numerics_policy


def set_numerics_policy(policy: str | None) -> None:
    """Set the process-wide policy (``None`` re-reads ``FASTKRON_NUMERICS``)."""
    global _numerics_policy
    if policy is not None and policy not in NUMERICS_POLICIES:
        raise PlanError(
            f"unknown numerics policy {policy!r}: want one of {NUMERICS_POLICIES}"
        )
    _numerics_policy = _env_policy() if policy is None else policy


class numerics(object):
    """Context manager scoping a numerics policy."""

    def __init__(self, policy: str):
        self._policy = policy
        self._prev: str | None = None

    def __enter__(self):
        global _numerics_policy
        self._prev = _numerics_policy
        set_numerics_policy(self._policy)
        return self

    def __exit__(self, *exc):
        global _numerics_policy
        _numerics_policy = self._prev
        return False


def _handle_nonfinite(where: str, policy: str) -> None:
    msg = f"non-finite values at guarded boundary {where!r}"
    record_event("nonfinite", NumericsError(msg))
    if policy == "raise":
        raise NumericsError(msg)
    warn_once(("nonfinite", where), f"kron guard: {msg}")


def check_finite(y: torch.Tensor, where: str) -> torch.Tensor:
    """Non-finite guard at a StageProgram boundary; returns ``y`` unchanged.

    Policy ``off`` costs one string compare and touches no tensor.  Under
    ``warn`` and ``raise`` the ``isfinite`` reduction runs on ``y``'s device
    and its flag is read on the host (a synchronisation with the device);
    ``raise`` raises ``NumericsError`` on the spot.  It guards the value the
    next stage consumes, after any ``acc_dtype`` downcast, on every backend.
    """
    policy = numerics_policy()
    if policy == "off":
        return y
    if not bool(torch.isfinite(y).all()):
        _handle_nonfinite(where, policy)
    return y


__all__ = [
    "KronError",
    "PlanError",
    "VmemOverflowError",
    "LoweringError",
    "CollectiveError",
    "PlanCacheError",
    "NumericsError",
    "GuardWarning",
    "OpHealth",
    "run_ladder",
    "health",
    "health_entries",
    "health_report",
    "record_event",
    "reset_health",
    "warn_once",
    "warn_deprecated_once",
    "check_finite",
    "numerics",
    "numerics_policy",
    "set_numerics_policy",
    "DEFAULT_PATIENCE",
    "NUMERICS_POLICIES",
]
