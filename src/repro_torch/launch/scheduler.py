"""Continuous-batching scheduler: a pure, deterministic state machine.

The port's own copy of ``repro.launch.scheduler``, which is plain Python:
the same policy, decisions and traces (tests/test_torch_scheduler.py holds
the two equal).  This module is the decision core of the serving engine (docs/serving.md).
It imports no framework and touches no device: every scheduling decision is a
pure function ``step(state, events) -> (state, actions)`` over frozen
dataclasses, so the whole policy is unit-testable as a simulation
(``simulate``) and bit-identical under replay with the same seed.  The
device side lives in ``launch/serve.py`` (``ServeEngine``), which executes
the emitted actions against the real model and feeds the observed events
(arrivals, EOS) back into the next ``step``.

Policy, in one paragraph: incoming prompts queue per **padding bucket**
(the smallest configured bucket that fits the prompt — each bucket shape
maps to one pre-resolved ``KronOp`` plan, see ``train.prebuild_kron_ops``).
A bucket group is launched as one prefill when it can fill the free decode
slots, when its oldest request has waited ``max_wait`` steps (the
starvation bound), or when the engine is idle.  Prefilled requests are
admitted into free decode **slots** on the next step (continuous batching);
slots recycle the moment a request finishes (EOS event or ``max_new``).
Each step emits at most ONE of ``prefill`` | ``decode`` — a prefill can
delay the next decode step but never preempts a decode batch mid-step.

Events (inputs to ``step``) are plain tuples::

    ("arrive", Request(...))    a new prompt entered the system
    ("eos", rid)                the model emitted EOS for ``rid`` during
                                the previous decode action

Actions (outputs of ``step``) are plain tuples, in execution order::

    ("reject", rid, reason)     prompt longer than the largest bucket
    ("admit", rid, slot)        a prefilled request took decode slot
    ("prefill", bucket, rids)   run one padded prefill for this group;
                                produces each request's FIRST token
    ("decode", rids)            one decode step over the occupied slots
                                (rids in slot order); one token per rid
    ("finish", rid, reason)     request left its slot ("eos" | "max_new")
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, replace
from typing import Iterable, Sequence

FINISH_REASONS = ("eos", "max_new")
REQUEST_STATES = ("queued", "prefilling", "decoding", "finished", "rejected")


@dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduling policy knobs.

    ``buckets``: ascending prompt padding buckets; a prompt is padded to the
    smallest bucket that fits it (one prefill plan per bucket shape).
    ``max_slots``: decode batch size == number of in-flight requests.
    ``max_prefill``: max requests coalesced into one prefill launch.
    ``max_wait``: starvation bound — a queued request whose bucket group is
    not yet full is force-scheduled once it has waited this many steps.
    """

    buckets: tuple[int, ...] = (16, 32, 64, 128)
    max_slots: int = 8
    max_prefill: int = 4
    max_wait: int = 8

    def __post_init__(self):
        b = tuple(int(x) for x in self.buckets)
        if not b or any(x <= 0 for x in b) or list(b) != sorted(set(b)):
            raise ValueError(
                f"buckets must be positive, strictly ascending: {self.buckets}"
            )
        object.__setattr__(self, "buckets", b)
        if self.max_slots <= 0 or self.max_prefill <= 0 or self.max_wait < 0:
            raise ValueError(
                "max_slots/max_prefill must be positive and max_wait >= 0: "
                f"{self.max_slots}, {self.max_prefill}, {self.max_wait}"
            )

    def bucket_for(self, prompt_len: int) -> int | None:
        """The smallest admissible padding bucket (None = prompt too long)."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return None


@dataclass(frozen=True)
class Request:
    """One serving request as the scheduler sees it.

    ``arrival`` is in driver units (steps for the simulator, seconds for the
    wall-clock engine) and is carried through untouched — the scheduler
    itself only orders by event delivery."""

    rid: int
    prompt_len: int
    max_new: int
    arrival: float = 0.0


@dataclass(frozen=True)
class _Queued:
    req: Request
    since: int  # step the request entered the queue (starvation clock)


@dataclass(frozen=True)
class Slot:
    """An occupied decode slot: ``generated`` counts emitted tokens
    (the prefill's first token included)."""

    rid: int
    prompt_len: int
    bucket: int
    generated: int
    max_new: int


@dataclass(frozen=True)
class SchedulerState:
    """The complete scheduler state; every field is immutable data.

    Request lifecycle: queued -> prefilling -> (slot = decoding) ->
    finished; over-long prompts go straight to rejected.  ``prefilling``
    holds the group issued as last step's prefill action together with the
    slots reserved for it (``pending_slots``) — they are admitted at the
    START of the next step, so a prefill result is never mixed into a
    decode batch mid-step."""

    cfg: SchedulerConfig
    step_idx: int = 0
    queued: tuple[_Queued, ...] = ()
    prefilling: tuple[Request, ...] = ()
    pending_slots: tuple[int, ...] = ()
    pending_bucket: int = 0
    slots: tuple[Slot | None, ...] = ()
    finished: tuple[tuple[int, str], ...] = ()
    rejected: tuple[int, ...] = ()


def new_state(cfg: SchedulerConfig) -> SchedulerState:
    return SchedulerState(cfg=cfg, slots=(None,) * cfg.max_slots)


def audit(state: SchedulerState) -> dict[int, str]:
    """rid -> lifecycle state, for every request the scheduler has seen.
    Raises ``ValueError`` if any rid appears in two places (conservation
    violation) — the hypothesis property in tests/test_properties.py runs
    this after every step."""
    seen: dict[int, str] = {}

    def put(rid: int, where: str) -> None:
        if rid in seen:
            raise ValueError(
                f"conservation violated: rid {rid} is both {seen[rid]} "
                f"and {where}"
            )
        seen[rid] = where

    for q in state.queued:
        put(q.req.rid, "queued")
    for r in state.prefilling:
        put(r.rid, "prefilling")
    for s in state.slots:
        if s is not None:
            put(s.rid, "decoding")
    for rid, _ in state.finished:
        put(rid, "finished")
    for rid in state.rejected:
        put(rid, "rejected")
    return seen


def _pick_group(
    cfg: SchedulerConfig,
    queued: Sequence[_Queued],
    t: int,
    free: int,
    decoding: bool,
) -> tuple[int, list[_Queued]] | None:
    """The bucket group to prefill this step, or None.

    Groups queued requests by their smallest admissible bucket (queue
    order preserved).  A group is READY when it can fill the takeable
    slots (``min(max_prefill, free)``), when its head request has waited
    ``max_wait`` steps, or when nothing is decoding (idle engine — there
    is no batch to coalesce against, so waiting only adds latency).
    Among ready groups the one with the OLDEST head request wins
    (FIFO across buckets; ties break toward the smaller bucket)."""
    if free <= 0 or not queued:
        return None
    groups: dict[int, list[_Queued]] = {}
    for q in queued:
        b = cfg.bucket_for(q.req.prompt_len)
        assert b is not None  # over-long prompts were rejected at arrival
        groups.setdefault(b, []).append(q)
    take = min(cfg.max_prefill, free)
    ready = [
        (g[0].since, b, g)
        for b, g in groups.items()
        if len(g) >= take or (t - g[0].since) >= cfg.max_wait or not decoding
    ]
    if not ready:
        return None
    _, bucket, group = min(ready, key=lambda r: (r[0], r[1]))
    return bucket, group[:take]


def step(
    state: SchedulerState, events: Iterable[tuple]
) -> tuple[SchedulerState, tuple[tuple, ...]]:
    """One scheduling decision: ``(state, events) -> (state', actions)``.

    Pure and total: no clock, no randomness, no device.  Processing order
    within the step — admissions of last step's prefill group, then
    arrivals, then EOS finishes (freed slots are immediately reusable),
    then ONE of prefill | decode.  A decode action increments every
    occupied slot's ``generated`` and finishes slots reaching ``max_new``
    in the same step, so the engine never runs a wasted token."""
    cfg = state.cfg
    t = state.step_idx
    actions: list[tuple] = []
    queued = list(state.queued)
    slots = list(state.slots)
    finished = list(state.finished)
    rejected = list(state.rejected)

    # 1. Admissions: last step's prefill group takes its reserved slots.
    for req, si in zip(state.prefilling, state.pending_slots):
        actions.append(("admit", req.rid, si))
        slot = Slot(
            rid=req.rid, prompt_len=req.prompt_len,
            bucket=state.pending_bucket, generated=1, max_new=req.max_new,
        )
        if slot.generated >= slot.max_new:  # max_new == 1: prefill was all
            actions.append(("finish", req.rid, "max_new"))
            finished.append((req.rid, "max_new"))
        else:
            slots[si] = slot

    # 2. Arrivals queue (or are rejected when no bucket fits).
    eos_rids: list[int] = []
    for ev in events:
        if ev[0] == "arrive":
            req: Request = ev[1]
            if cfg.bucket_for(req.prompt_len) is None:
                actions.append(("reject", req.rid, "prompt_too_long"))
                rejected.append(req.rid)
            else:
                queued.append(_Queued(req, t))
        elif ev[0] == "eos":
            eos_rids.append(ev[1])
        else:
            raise ValueError(f"unknown event {ev!r}")

    # 3. EOS finishes recycle slots (stale EOS for an already-finished
    #    request — e.g. max_new fired the same decode — is ignored).
    for rid in eos_rids:
        for si, s in enumerate(slots):
            if s is not None and s.rid == rid:
                actions.append(("finish", rid, "eos"))
                finished.append((rid, "eos"))
                slots[si] = None
                break

    # 4. Schedule: one prefill OR one decode, never both.
    free = [si for si, s in enumerate(slots) if s is None]
    reserved = []
    prefilling: tuple[Request, ...] = ()
    pending_bucket = 0
    decoding = any(s is not None for s in slots)
    group = _pick_group(cfg, queued, t, len(free), decoding)
    if group is not None:
        bucket, entries = group
        reserved = free[: len(entries)]
        taken = {id(e) for e in entries}
        queued = [q for q in queued if id(q) not in taken]
        prefilling = tuple(e.req for e in entries)
        pending_bucket = bucket
        actions.append(("prefill", bucket, tuple(r.rid for r in prefilling)))
    elif decoding:
        rids = tuple(s.rid for s in slots if s is not None)
        actions.append(("decode", rids))
        for si, s in enumerate(slots):
            if s is None:
                continue
            s = replace(s, generated=s.generated + 1)
            if s.generated >= s.max_new:
                actions.append(("finish", s.rid, "max_new"))
                finished.append((s.rid, "max_new"))
                slots[si] = None
            else:
                slots[si] = s

    new = replace(
        state,
        step_idx=t + 1,
        queued=tuple(queued),
        prefilling=prefilling,
        pending_slots=tuple(reserved),
        pending_bucket=pending_bucket,
        slots=tuple(slots),
        finished=tuple(finished),
        rejected=tuple(rejected),
    )
    return new, tuple(actions)


# ---------------------------------------------------------------------------
# Synthetic open-loop arrival driver + device-free simulation
# ---------------------------------------------------------------------------


def poisson_trace(
    *,
    seed: int,
    rate: float,
    n: int,
    prompt_lens: tuple[int, int] = (4, 48),
    max_new: tuple[int, int] = (4, 16),
    start: float = 0.0,
) -> tuple[Request, ...]:
    """An open-loop Poisson arrival trace: ``n`` requests with exponential
    inter-arrival gaps at ``rate`` (requests per driver time unit), prompt
    lengths and token budgets uniform over the given inclusive ranges.
    Pure function of the arguments (``random.Random(seed)``) — the same
    seed replays the same trace, which is what makes the end-to-end replay
    test bit-identical."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = random.Random(seed)
    t = float(start)
    out = []
    for rid in range(n):
        t += rng.expovariate(rate)
        out.append(
            Request(
                rid=rid,
                prompt_len=rng.randint(*prompt_lens),
                max_new=rng.randint(*max_new),
                arrival=t,
            )
        )
    return tuple(out)


def sim_token(rid: int, index: int) -> int:
    """The simulated model: token ``index`` of request ``rid``.  A pure
    function of (rid, index) — so any dependence of a request's emitted
    sequence on its co-batched neighbours in a simulation is, by
    construction, a scheduler bug (wrong slot attribution)."""
    return (rid * 1000003 + index * 7919 + 12345) % 50021


@dataclass(frozen=True)
class SimResult:
    """Everything a deterministic simulation produced.

    ``trace``: the full ``(step_idx, action)`` sequence — the replay
    artifact two equal-seed runs must match bit-for-bit.
    ``tokens``: rid -> emitted token tuple.  ``metrics``: rid -> dict with
    ``arrival_step`` / ``first_token_step`` / ``admit_step`` /
    ``finish_step`` / ``reason``.  ``queue_depth``: per-step queue length.
    """

    trace: tuple[tuple[int, tuple], ...]
    tokens: dict[int, tuple[int, ...]]
    metrics: dict[int, dict]
    queue_depth: tuple[int, ...]
    steps: int


def simulate(
    cfg: SchedulerConfig,
    requests: Sequence[Request],
    *,
    seed: int = 0,
    max_steps: int = 100_000,
    check: bool = True,
) -> SimResult:
    """Run the scheduler against the simulated model, device-free.

    Arrivals become visible at ``step >= floor(req.arrival)`` (the trace's
    time unit is scheduler steps).  Each request's TRUE generation length
    is drawn deterministically from ``(seed, rid)`` — when it is below the
    request's ``max_new`` the driver feeds an ``eos`` event one step after
    the final token, exercising slot recycling on both finish paths.
    ``check=True`` audits conservation after every step."""
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    gen_len = {
        r.rid: 1 + random.Random(f"{seed}:{r.rid}").randrange(r.max_new)
        for r in pending
    }
    state = new_state(cfg)
    trace: list[tuple[int, tuple]] = []
    tokens: dict[int, list[int]] = {}
    metrics: dict[int, dict] = {
        r.rid: {"arrival_step": int(r.arrival)} for r in pending
    }
    qdepth: list[int] = []
    eos_next: list[tuple] = []
    n_done = 0
    i = 0
    while n_done < len(pending) and state.step_idx < max_steps:
        t = state.step_idx
        events = list(eos_next)
        eos_next = []
        while i < len(pending) and int(pending[i].arrival) <= t:
            events.append(("arrive", pending[i]))
            i += 1
        state, actions = step(state, events)
        if check:
            audit(state)
        for act in actions:
            trace.append((t, act))
            kind = act[0]
            if kind == "prefill":
                for rid in act[2]:
                    tokens[rid] = [sim_token(rid, 0)]
                    metrics[rid]["first_token_step"] = t
                    if gen_len[rid] == 1:
                        eos_next.append(("eos", rid))
            elif kind == "admit":
                metrics[act[1]]["admit_step"] = t
            elif kind == "decode":
                for rid in act[1]:
                    idx = len(tokens[rid])
                    tokens[rid].append(sim_token(rid, idx))
                    if len(tokens[rid]) == gen_len[rid]:
                        eos_next.append(("eos", rid))
            elif kind in ("finish", "reject"):
                rid = act[1]
                metrics[rid]["finish_step"] = t
                metrics[rid]["reason"] = act[2]
                n_done += 1
        qdepth.append(len(state.queued))
        if not actions and not events and i < len(pending):
            # idle gap before the next arrival: fast-forward the clock
            nxt = int(pending[i].arrival)
            state = replace(state, step_idx=max(state.step_idx, nxt))
    return SimResult(
        trace=tuple(trace),
        tokens={rid: tuple(v) for rid, v in tokens.items()},
        metrics=metrics,
        queue_depth=tuple(qdepth),
        steps=state.step_idx,
    )


__all__ = [
    "SchedulerConfig",
    "Request",
    "Slot",
    "SchedulerState",
    "new_state",
    "step",
    "audit",
    "poisson_trace",
    "sim_token",
    "simulate",
    "SimResult",
    "FINISH_REASONS",
    "REQUEST_STATES",
]
