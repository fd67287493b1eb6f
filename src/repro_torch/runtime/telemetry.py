"""KronScope: the process-local tracing/metrics spine.

The port of ``repro.runtime.telemetry``: one telemetry layer for the whole
Kron-Matmul path (plan, program, stage, ladder, chaos), with the same names,
records and exports as the reference.  Three pieces:

* **Spans** — ``span("stage", kind=...)`` times a region host-side
  (``perf_counter``) and, while telemetry is active, wraps it in
  ``torch.profiler.record_function("kronscope.<name>")`` (and an NVTX range
  when a CUDA device is present), so the region is attributable in a
  ``torch.profiler`` trace next to the kernels it launched.  Spans nest;
  each completed span also feeds the ``span.<name>`` histogram.  Host time
  is what a span measures: kernels launch asynchronously, so a span around
  a launch ends before the device finishes unless the caller synchronises.

* **Metrics** — a registry of counters (``counter_inc``), gauges
  (``gauge_set``) and histograms (``observe``, with p50/p95/p99 via
  ``percentiles``), fed by the guard (rung fallbacks, pins, warnings) and
  chaos (injections) layers.

* **Export** — every span and event streams to a JSONL sink
  (``repro_torch.runtime.events.EventSink``) and completed spans export as
  Chrome-trace JSON (``chrome://tracing`` / Perfetto) via
  ``write_chrome_trace``.

Disabled (the default) the layer is inert: every instrumentation site costs
one module-global truthiness check, and ``span()`` returns a shared no-op
that enters no ``record_function`` and no NVTX range (pinned by
``tests/test_torch_telemetry.py`` with ``torch.profiler``).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

import torch

from .events import EventSink

# Bounded in-memory buffers: telemetry must never become the memory leak it
# exists to find.  Oldest entries drop first; drops are counted, not silent.
SPAN_BUFFER = 65536
HIST_BUFFER = 8192

DRIFT_THRESHOLD = 2.0  # default measured/predicted per-stage drift ratio flag


class _Telemetry:
    """The live telemetry state; exists only while telemetry is active."""

    def __init__(self, jsonl=None, trace=None, annotate: bool = True):
        self.t0 = time.perf_counter()
        self.started_at = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.annotate = bool(annotate)
        # NVTX ranges only where a CUDA device exists: a CPU build of torch
        # has no NVTX library to call.
        self.nvtx = self.annotate and torch.cuda.is_available()
        self.sink = EventSink(jsonl) if jsonl else None
        self.trace_path = str(trace) if trace else None
        self.lock = threading.RLock()
        self.tls = threading.local()
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, list[float]] = {}
        self.spans: list[dict] = []
        self.dropped_spans = 0
        self.n_events = 0
        self.last_profile: dict | None = None

    def stack(self) -> list:
        s = getattr(self.tls, "stack", None)
        if s is None:
            s = self.tls.stack = []
        return s


_STATE: _Telemetry | None = None


def active() -> bool:
    """True while telemetry is configured — the one check every site pays."""
    return _STATE is not None


def configure(jsonl=None, trace=None, *, annotate: bool = True) -> None:
    """Activate telemetry for the process.

    ``jsonl``: path for the JSONL event stream (None = in-memory only).
    ``trace``: path ``shutdown()`` writes the Chrome trace to.
    ``annotate``: wrap spans in ``torch.profiler.record_function`` (and an
    NVTX range on CUDA); disable to time host-side only.
    Reconfiguring replaces the previous state (its sink is closed).
    """
    global _STATE
    old, _STATE = _STATE, _Telemetry(jsonl, trace, annotate=annotate)
    if old is not None and old.sink is not None:
        old.sink.close()


def disable() -> None:
    """Deactivate without exporting; the sink is closed, buffers dropped."""
    global _STATE
    old, _STATE = _STATE, None
    if old is not None and old.sink is not None:
        old.sink.close()


def reset() -> None:
    """Tests: drop all telemetry state and deactivate."""
    disable()


def shutdown() -> dict | None:
    """Finalize: write the Chrome trace (if configured), flush and close the
    JSONL sink, deactivate.  Returns the final ``snapshot()`` (None if
    telemetry was not active), the same snapshot ``guard.health_report()``
    embeds."""
    st = _STATE
    if st is None:
        return None
    snap = snapshot()
    if st.trace_path:
        write_chrome_trace(st.trace_path)
    disable()
    return snap


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """Shared no-op span: the entire off-path cost of a ``span()`` site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("state", "name", "attrs", "depth", "t_start", "_rf")

    def __init__(self, state: _Telemetry, name: str, attrs: dict):
        self.state = state
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = self.state
        stack = st.stack()
        self.depth = len(stack)
        stack.append(self.name)
        if st.annotate:
            self._rf = torch.profiler.record_function(f"kronscope.{self.name}")
            self._rf.__enter__()
            if st.nvtx:
                torch.cuda.nvtx.range_push(f"kronscope.{self.name}")
        else:
            self._rf = None
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t_start
        st = self.state
        if self._rf is not None:
            if st.nvtx:
                torch.cuda.nvtx.range_pop()
            self._rf.__exit__(*exc)
        stack = st.stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        rec = {
            "name": self.name,
            "ts": self.t_start - st.t0,
            "dur": dur,
            "depth": self.depth,
            "tid": threading.get_ident(),
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        with st.lock:
            st.spans.append(rec)
            if len(st.spans) > SPAN_BUFFER:
                del st.spans[0]
                st.dropped_spans += 1
            _observe_locked(st, f"span.{self.name}", dur)
        if st.sink is not None:
            st.sink.emit({"kind": "span", **rec})
        return False


def span(name: str, **attrs):
    """Context manager timing a region; a shared no-op when inactive.

    Active: records host wall time, nests (depth tracked per thread), wraps
    the region in ``torch.profiler.record_function`` (and an NVTX range on
    CUDA; prefix ``kronscope.``), streams to the JSONL sink, and feeds the
    ``span.<name>`` histogram.
    """
    st = _STATE
    if st is None:
        return _NULL_SPAN
    return _Span(st, name, attrs)


def record_span(name: str, start: float, dur: float, **attrs) -> None:
    """Inject a completed span directly, bypassing the nesting stack.

    ``span()`` assumes strictly nested regions (one per-thread stack) —
    per-REQUEST lifetimes in the serving engine overlap arbitrarily (a
    request admitted mid-decode outlives requests that started before it),
    so the engine times them itself and injects the finished interval here.
    ``start`` is an absolute ``time.perf_counter()`` stamp; the span lands
    in the same buffer/sink/histogram pipeline as ``span()`` (depth 0).
    No-op while inactive."""
    st = _STATE
    if st is None:
        return
    rec = {
        "name": name,
        "ts": float(start) - st.t0,
        "dur": float(dur),
        "depth": 0,
        "tid": threading.get_ident(),
    }
    if attrs:
        rec["attrs"] = attrs
    with st.lock:
        st.spans.append(rec)
        if len(st.spans) > SPAN_BUFFER:
            del st.spans[0]
            st.dropped_spans += 1
        _observe_locked(st, f"span.{name}", float(dur))
    if st.sink is not None:
        st.sink.emit({"kind": "span", **rec})


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


def event(name: str, **fields) -> None:
    """Record a structured event: counted (``event.<name>``) and streamed to
    the JSONL sink.  One truthiness check when inactive."""
    st = _STATE
    if st is None:
        return
    with st.lock:
        st.n_events += 1
        key = f"event.{name}"
        st.counters[key] = st.counters.get(key, 0) + 1
    if st.sink is not None:
        st.sink.emit(
            {"kind": "event", "name": name,
             "ts": time.perf_counter() - st.t0, **fields}
        )


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def counter_inc(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (no-op while inactive)."""
    st = _STATE
    if st is None:
        return
    with st.lock:
        st.counters[name] = st.counters.get(name, 0) + n


def gauge_set(name: str, value) -> None:
    """Set gauge ``name`` to ``value`` (last write wins; no-op inactive)."""
    st = _STATE
    if st is None:
        return
    with st.lock:
        st.gauges[name] = value


def observe(name: str, value: float) -> None:
    """Record one sample into histogram ``name`` (no-op while inactive)."""
    st = _STATE
    if st is None:
        return
    with st.lock:
        _observe_locked(st, name, float(value))


def _observe_locked(st: _Telemetry, name: str, value: float) -> None:
    h = st.hists.get(name)
    if h is None:
        h = st.hists[name] = []
    h.append(value)
    if len(h) > HIST_BUFFER:
        del h[0]


def _pcts(values: list[float]) -> dict:
    v = sorted(values)
    n = len(v)

    def at(q: float) -> float:
        return v[min(n - 1, int(q * (n - 1)))]

    return {
        "count": n,
        "min": v[0],
        "max": v[-1],
        "mean": sum(v) / n,
        "p50": at(0.50),
        "p95": at(0.95),
        "p99": at(0.99),
    }


def percentiles(name: str) -> dict | None:
    """``{count, min, max, mean, p50, p95, p99}`` for histogram ``name``
    (index-based percentiles on the retained samples), or None."""
    st = _STATE
    if st is None:
        return None
    with st.lock:
        h = st.hists.get(name)
        return _pcts(h) if h else None


def snapshot() -> dict:
    """The full registry as plain data: counters, gauges, histogram
    summaries, span/event totals, and the last ``KronOp.profile`` stamp.
    ``guard.health_report()`` embeds this, so one report carries both."""
    st = _STATE
    if st is None:
        return {}
    with st.lock:
        return {
            "started_at": st.started_at,
            "counters": dict(st.counters),
            "gauges": dict(st.gauges),
            "histograms": {k: _pcts(v) for k, v in st.hists.items() if v},
            "spans": len(st.spans) + st.dropped_spans,
            "events": st.n_events,
            "last_profile": st.last_profile,
        }


def comm_summary() -> dict:
    """Aggregate the distributed comm gauges into per-round structure.

    The mesh rounds gauge ``comm.round<k>.elems_per_device`` (round total)
    and, when the round is slab-pipelined, ``comm.round<k>.slab<s>.
    elems_per_device`` per slab.  Returns ``{round: {"total": float,
    "slabs": [per-slab payloads in slab order], "hidden": float}}`` where
    ``hidden`` is the overlap accounting the gauges imply — everything except
    one exposed slab per round (0 for serial rounds).  ``KronOp.profile()``
    reconciles ``KronCost.comm_hidden_elems`` against this; ``{}`` while
    inactive or before any mesh round ran.  ``core.distributed``'s rounds
    set the gauges, in the reference's format."""
    st = _STATE
    if st is None:
        return {}
    pat = re.compile(r"^comm\.round(\d+)\.(?:slab(\d+)\.)?elems_per_device$")
    rounds: dict[int, dict] = {}
    with st.lock:
        items = list(st.gauges.items())
    for name, value in items:
        m = pat.match(name)
        if m is None:
            continue
        k = int(m.group(1))
        rec = rounds.setdefault(k, {"total": 0.0, "slabs": {}})
        if m.group(2) is None:
            rec["total"] = float(value)
        else:
            rec["slabs"][int(m.group(2))] = float(value)
    out: dict[int, dict] = {}
    for k, rec in sorted(rounds.items()):
        slabs = [rec["slabs"][s] for s in sorted(rec["slabs"])]
        hidden = rec["total"] - max(slabs) if len(slabs) > 1 else 0.0
        out[k] = {"total": rec["total"], "slabs": slabs, "hidden": hidden}
    return out


def summary_line() -> str:
    """One-line state summary (``KronOp.describe()`` appends this while
    telemetry is active)."""
    st = _STATE
    if st is None:
        return "kronscope[off]"
    with st.lock:
        prof = st.last_profile["at"] if st.last_profile else "never"
        return (
            f"kronscope[spans={len(st.spans) + st.dropped_spans} "
            f"events={st.n_events} last_profile={prof}]"
        )


def mark_profile(report: dict) -> None:
    """Stamp the latest ``KronOp.profile`` report, or any dict of that
    shape (timestamp + headline fields), into the registry and emit a
    ``profile`` event."""
    st = _STATE
    if st is None:
        return
    stamp = {
        "at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "signature": report.get("signature"),
        "measured_s": report.get("measured_s"),
        "stages": len(report.get("stages", ())),
        "drift_flagged": report.get("drift_flagged"),
    }
    with st.lock:
        st.last_profile = stamp
    event("profile", **stamp)


# ---------------------------------------------------------------------------
# Chrome-trace (Perfetto) export
# ---------------------------------------------------------------------------


def write_chrome_trace(path: str | None = None) -> str | None:
    """Export completed spans as Chrome trace-event JSON (``chrome://tracing``
    / Perfetto: ``{"traceEvents": [{"ph": "X", ...}]}``, timestamps in µs).
    ``path=None`` uses the ``trace=`` path from ``configure``.  Returns the
    written path (None if inactive or no path is known)."""
    st = _STATE
    if st is None:
        return None
    path = str(path) if path else st.trace_path
    if not path:
        return None
    pid = os.getpid()
    with st.lock:
        events = [
            {
                "name": s["name"],
                "ph": "X",
                "ts": s["ts"] * 1e6,
                "dur": s["dur"] * 1e6,
                "pid": pid,
                "tid": s["tid"],
                "args": {**s.get("attrs", {}), "depth": s["depth"]},
            }
            for s in st.spans
        ]
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "kronscope", "started_at": st.started_at},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


__all__ = [
    "active",
    "configure",
    "disable",
    "reset",
    "shutdown",
    "span",
    "record_span",
    "event",
    "counter_inc",
    "gauge_set",
    "observe",
    "percentiles",
    "snapshot",
    "comm_summary",
    "summary_line",
    "mark_profile",
    "write_chrome_trace",
    "DRIFT_THRESHOLD",
    "SPAN_BUFFER",
    "HIST_BUFFER",
]
