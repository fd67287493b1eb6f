"""Distributed Kron-Matmul (paper §5, contribution C4) on a DeviceMesh.

The port of ``repro.core.distributed``.  The device grid ``(G_M, G_K)`` is
a ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``; ``x`` is a ``DTensor`` placed ``(Shard(0), Shard(1))`` (rows
over ``data``, columns over ``model``), the per-sample ``(B, M, K)`` form
``(Shard(1), Shard(2))``; the factors are plain replicated tensors (or
``Replicate()`` DTensors).  A tuple ``data_axis`` shards the rows over
several mesh dims.  The rounds run SPMD on ``x.to_local()`` in every
rank, inside one ``torch.autograd.Function`` (``_Rounds``, the counterpart
of the reference's ``custom_vjp``), and come back as a DTensor with the
same placements.

Each round performs ``L`` local sliced multiplies (valid while ``prod(P) |
K_loc``) and then relocates the distributed intermediate with ONE
all-to-all over the model axis plus a local transpose.  After ``L`` local
multiplies, local column ``(q_vec, s)`` on rank ``g_k`` is global column
``(q_vec*G_K + g_k)*U + s`` with ``U = K_loc / prod(P)``: the canonical
layout (each rank owns a contiguous stripe) needs exactly the rows ``q_vec``
in the rank's chunk of the q-axis.  So the q-axis is viewed as ``(G_K,
Q^L/G_K)``, the leading chunk axis is exchanged, and the received rank axis
is swapped with the q-chunk axis.  ``all_to_all_single`` splits dim 0, so
the chunk axis of the ``(b, m_loc, g_k, chunk, u)`` view is moved to the
front before the call (``movedim(2, 0).contiguous()``, one copy) and the
received rank axis moved into place after it (one more copy); the
reference's ``jax.lax.all_to_all`` splits its axis 2 in place.

A round's local multiplies are chain instructions on the emitter: on CUDA
tensors ``chain_fwd`` launches (``emit.run_stage``), one per sub-chain that
one block holds (``_round_instrs``; the reference runs one chain per round
because a TPU core's VMEM holds it), and the per-factor kernels when not
even one factor fits, or under the ``round_chain`` chaos site
(``round_per_factor`` event).  The backward walks each round per factor:
``sliced`` re-materialises the in-round inputs, ``sliced_t`` (the chain
kernels' transposed chain-of-one for per-sample factors) carries the
cotangent, and each factor's gradient is one ``torch.einsum`` over the
round's full local rows, summed over every rank of the mesh (in f32, or
f64 for f64) before the cast to the factor's dtype: the reference's
shard_map sums a replicated input's cotangent the same way.

Communication per device per round: ``M_loc * C_loc * (G_K-1)/G_K``
elements with ``ceil(N/L)`` rounds, against ``N`` rounds for the
per-iteration baseline (``per_iteration=True``, CTF/DISTAL).  Per-sample
batches move one ``(B, M_loc, C_loc)`` slab per round.

Slab pipeline: ``n_slabs > 1`` splits the local rows into slabs, and each
round issues slab ``s``'s all-to-all (``async_op=True``) right after its
chain, then waits for slab ``s-1``'s and moves it into the round's output,
so each exchange runs under the next slab's chain; the next round starts
after the last slab's wait.  The backward mirrors it with the inverse
relocations.
Slab boundaries are row boundaries, so the slabbed schedule is bitwise
equal to the serial one, forward and gradients: each factor gradient is one
contraction over the concatenated slabs, never a sum of per-slab partials.

Memory: the first round writes one new output stripe, and every later
round whose output is as wide as its input writes each slab back over the
rows its chain has read, so a rank holds ``x_loc``, one more stripe and
the slabs in flight (``round_working_set_bytes``); a problem whose
``x`` no rank holds is placed from each rank's own shard
(``sharded_input_from_local``).

The code names no backend: the mesh's process groups decide (NCCL with one
rank per card, gloo with several ranks on one card or on the CPU).  The
launch counters ``all_to_all_calls`` and ``all_to_all_elems`` (elements
sent per device, ``numel * (G_K-1)/G_K``) grow by one call where a
relocation is issued and nowhere else; with telemetry on, so do the
counters ``comm.a2a_calls`` and ``comm.a2a_bytes`` (bytes sent per
device), each issue is a ``relocate`` span (the send copy and the
collective's launch) and each wait a ``relocate_wait`` span.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..kernels import emit
from ..runtime import chaos, guard, telemetry

# Relocations issued (one all-to-all each) and the elements each sent per
# device: +1 and +numel*(G_K-1)/G_K where ``_relocate_start`` issues one.
all_to_all_calls = 0
all_to_all_elems = 0


# ---------------------------------------------------------------------------
# Static round planning
# ---------------------------------------------------------------------------


def plan_rounds(
    k_loc: int, ps: Sequence[int], qs: Sequence[int], g_k: int,
    *, minimal: bool = False,
) -> list[int]:
    """Split the reversed factor list into rounds of local multiplies.

    Round length L must satisfy (i) ``prod(P) | K_loc`` (all slices stay
    rank-local) and (ii) ``G_K | prod(Q)`` (the q-axis can be chunked over
    ranks for the relocation).  FastKron (``minimal=False``) takes the
    largest valid L, the paper's communication-minimising batching; the
    CTF/DISTAL-style baseline (``minimal=True``) the smallest.  Raises
    ``PlanError`` if even L=1 is invalid.
    """
    rounds: list[int] = []
    i = 0
    n = len(ps)
    while i < n:
        best = 0
        pprod = qprod = 1
        for j in range(i, n):
            pprod *= ps[j]
            qprod *= qs[j]
            if k_loc % pprod != 0:
                break
            if qprod % g_k == 0:
                best = j - i + 1
                if minimal:
                    break
        if best == 0:
            raise guard.PlanError(
                f"cannot relocate: need G_K={g_k} | prod(Q) for some prefix "
                f"with prod(P) | K_loc={k_loc}; got ps={ps[i:]}, qs={qs[i:]}"
            )
        pprod = math.prod(ps[i : i + best])
        qprod = math.prod(qs[i : i + best])
        k_loc = (k_loc // pprod) * qprod
        rounds.append(best)
        i += best
    return rounds


def _round_payloads(
    m_loc: int, k_loc: int, ps: Sequence[int], qs: Sequence[int], g_k: int,
    rounds: Sequence[int] | None, batch: int,
) -> list[int]:
    """Each round's all-to-all payload, elements sent per device."""
    ps, qs = list(ps), list(qs)
    if rounds is None:
        rounds = plan_rounds(k_loc, ps, qs, g_k)
    out = []
    i = 0
    c = k_loc
    for r in rounds:
        c = (c // math.prod(ps[i : i + r])) * math.prod(qs[i : i + r])
        out.append(batch * m_loc * c * (g_k - 1) // g_k)
        i += r
    return out


def comm_elems_per_device(
    m_loc: int, k_loc: int, ps: Sequence[int], qs: Sequence[int], g_k: int,
    rounds: Sequence[int] | None = None, *, batch: int = 1, n_slabs: int = 1,
) -> int:
    """Analytic all-to-all payload (elements sent per device, all rounds).

    ``batch``: problems riding the same collective round; the round count
    does not change with it.  ``n_slabs`` is accepted for symmetry and
    inert: slabs repartition each round's payload (equal row slabs, clamped
    by ``emit.effective_slabs``), they never change the total."""
    del n_slabs
    return sum(_round_payloads(m_loc, k_loc, ps, qs, g_k, rounds, batch))


def comm_hidden_elems(
    m_loc: int, k_loc: int, ps: Sequence[int], qs: Sequence[int], g_k: int,
    rounds: Sequence[int] | None = None, *, batch: int = 1, n_slabs: int = 1,
) -> int:
    """Of ``comm_elems_per_device``, the elements the slab pipeline can hide
    under a neighbouring slab's chain: per round everything but one slab's
    payload (``payload - payload/n``, ``n`` clamped as the executor clamps
    it).  0 for the serial schedule and for ``g_k=1``.  An upper bound: it
    assumes each slab's chain covers a slab's transfer."""
    n = emit.effective_slabs(m_loc, n_slabs)
    if n <= 1 or g_k <= 1:
        return 0
    return sum(p - p // n for p in _round_payloads(m_loc, k_loc, ps, qs, g_k, rounds, batch))


# ---------------------------------------------------------------------------
# The round body
# ---------------------------------------------------------------------------


def _record_round_comm(shapes: Sequence[tuple], g_k: int, k: int) -> None:
    """Per-round all-to-all payload gauges, one entry of ``shapes`` per slab:
    ``comm.round<k>.elems_per_device`` (the round's total, equal to the
    serial schedule's payload) and, when slabbed,
    ``comm.round<k>.slab<s>.elems_per_device`` (``telemetry.comm_summary``
    reads both)."""
    if not telemetry.active():
        return
    n = len(shapes)
    total = 0
    for s, shape in enumerate(shapes):
        elems = math.prod(int(d) for d in shape) * (g_k - 1) // g_k
        total += elems
        telemetry.observe("comm_elems_per_device", elems)
        if n > 1:
            telemetry.gauge_set(f"comm.round{k}.slab{s}.elems_per_device", elems)
    telemetry.gauge_set(f"comm.round{k}.elems_per_device", total)


@functools.lru_cache(maxsize=256)
def _round_tiles(
    m: int, k: int, ps: tuple[int, ...], qs: tuple[int, ...], acc_bytes: int, in_bytes: int,
) -> tuple[int, int]:
    """``(t_m, t_k)`` bounds for one chain launch of factors ``ps x qs`` on a
    ``(m, k)`` operand, checked by the executor's own geometry
    (``emit.chain_geometry`` at ``SMEM_BUDGET_ELEMS``): the largest ``t_k``
    at up to 8 rows, rows shrinking before slices.  The kernel picks its
    block tile inside them (``emit.block_tile``), which changes no result.
    Raises ``VmemOverflowError`` when not even one row of one contraction
    fits a block."""
    pprod = math.prod(ps)
    s = k // pprod
    fs = [(1, p, q) for p, q in zip(ps, qs)]
    for t_m in sorted((d for d in emit.divisors(m) if d <= 8), reverse=True):
        for d in sorted(emit.divisors(s), reverse=True):
            try:
                emit.chain_geometry((1, m, k), fs, t_m=t_m, t_k=d * pprod,
                                    acc_bytes=acc_bytes, in_bytes=in_bytes)
            except guard.VmemOverflowError:
                continue
            return t_m, d * pprod
    raise guard.VmemOverflowError(
        f"round chain {list(ps)}x{list(qs)} on ({m}, {k}): no block tile fits "
        f"{emit.SMEM_BUDGET_ELEMS} elements of shared memory"
    )


@functools.lru_cache(maxsize=256)
def _round_instrs(
    m: int, k: int, ps: tuple[int, ...], qs: tuple[int, ...], batched: bool,
    acc_bytes: int, in_bytes: int,
) -> tuple[tuple[emit.StageInstr, tuple[int, ...]], ...]:
    """One round's chain as ``(instruction, factor positions)`` launches: the
    fewest consecutive sub-chains of which each fits one block, longest
    first.  The grouping is decided at one row, so it does not depend on
    ``m`` and a slab runs the same sub-chains as the whole rows.  Raises
    ``VmemOverflowError`` when a single factor fits no block."""
    out = []
    i = 0
    cur = k
    while i < len(ps):
        j = len(ps)
        while j > i:
            try:
                _round_tiles(1, cur, ps[i:j], qs[i:j], acc_bytes, in_bytes)
                break
            except guard.VmemOverflowError:
                j -= 1
        if j == i:
            raise guard.VmemOverflowError(
                f"round factor {ps[i]}x{qs[i]} on K={cur}: no block tile fits"
            )
        t_m, t_k = _round_tiles(m, cur, ps[i:j], qs[i:j], acc_bytes, in_bytes)
        instr = emit.StageInstr(
            kind=emit.MULTIPLY, ps=ps[i:j], qs=qs[i:j], t_m=t_m, t_k=t_k,
            t_b=1 if batched else None,
        )
        out.append((instr, tuple(range(i, j))))
        cur = cur // math.prod(ps[i:j]) * math.prod(qs[i:j])
        i = j
    return tuple(out)


def _local_multiply_round(
    y: torch.Tensor, fs: Sequence[torch.Tensor], backend: str
) -> torch.Tensor:
    """One round's local multiplies: the round's chain as chain-kernel
    launches (``_round_instrs``), 2-D operands with shared factors or
    per-sample 3-D ones.  A round whose chain no block tile holds, or a
    fired ``round_chain`` chaos site, degrades to per-factor multiplies
    with a ``round_per_factor`` event: the same contraction, and the
    relocation schedule is untouched (the fallback is local)."""
    fs = tuple(fs)
    ps = tuple(int(f.shape[-2]) for f in fs)
    qs = tuple(int(f.shape[-1]) for f in fs)
    try:
        chaos.maybe_fail("round_chain")
        acc = emit.acc_dtype_for(y.dtype).itemsize
        instrs = _round_instrs(int(y.shape[-2]), int(y.shape[-1]), ps, qs,
                               fs[0].ndim == 3, acc, y.element_size())
        out = y
        for instr, ids in instrs:
            out = emit.run_stage(out, tuple(fs[i] for i in ids), instr, backend=backend)
        return out
    except guard.KronError as e:
        from .engine import _sliced_batched

        guard.record_event("round_per_factor", e)
        guard.warn_once(
            ("round_per_factor", ps, qs),
            f"kron guard: round chain {list(ps)}x{list(qs)} degraded to per-factor "
            f"multiplies ({type(e).__name__}: {e})",
        )
        for f in fs:
            y = _sliced_batched(y, f, backend)
        return y


# ---------------------------------------------------------------------------
# Relocation (the all-to-all and its transpose)
# ---------------------------------------------------------------------------

# ``exchange(send) -> (recv, wait)``: start the model axis's all-to-all of
# ``send`` (dim 0 holds one chunk per rank) and return the receive buffer
# and the function that waits for it.
Exchange = Callable[[torch.Tensor], tuple[torch.Tensor, Callable[[], None]]]


def group_exchange(group) -> Exchange:
    """The model axis's ``Exchange`` over a process group:
    ``all_to_all_single(async_op=True)``; the receive buffer is valid after
    ``wait``."""

    def exchange(send: torch.Tensor):
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=group, async_op=True)
        return recv, work.wait

    return exchange


class _Pending(NamedTuple):
    recv: torch.Tensor
    wait: Callable[[], None]
    shape: tuple[int, int, int]
    inverse: bool
    squeeze: bool


def _relocate_start(
    y: torch.Tensor, q_prod: int, g_k: int, exchange: Exchange, *, inverse: bool = False
) -> _Pending:
    """Issue one relocation of ``y`` (2-D, or 3-D per-sample): lay the
    chunks out along dim 0 (one copy) and start the exchange, inside one
    ``relocate`` span.  ``inverse`` issues the transpose (also the inverse:
    a relocation is a permutation).  ``y`` may come in a one-element list,
    which is emptied once the send copy is made: the caller's last
    reference, so that ``y`` is freed before the receive buffer is
    allocated."""
    global all_to_all_calls, all_to_all_elems
    with telemetry.span("relocate", inverse=inverse):
        src = y.pop() if isinstance(y, list) else y
        squeeze = src.ndim == 2
        y3 = src[None] if squeeze else src
        b, m_loc, c = (int(d) for d in y3.shape)
        u = c // q_prod
        chunk = q_prod // g_k
        if inverse:
            send = y3.reshape(b, m_loc, chunk, g_k, u).permute(3, 0, 1, 2, 4).contiguous()
        else:
            send = y3.reshape(b, m_loc, g_k, chunk, u).movedim(2, 0).contiguous()
        del src, y3
        recv, wait = exchange(send)
    elems = send.numel() * (g_k - 1) // g_k
    all_to_all_calls += 1
    all_to_all_elems += elems
    telemetry.counter_inc("comm.a2a_calls")
    telemetry.counter_inc("comm.a2a_bytes", elems * send.element_size())
    return _Pending(recv, wait, (b, m_loc, c), inverse, squeeze)


def _wait(p: _Pending) -> None:
    with telemetry.span("relocate_wait"):
        p.wait()


def _relocate_finish(p: _Pending, out: torch.Tensor | None = None) -> torch.Tensor:
    """Wait for a relocation and move the received rank axis into place:
    local column ``(q_lo * G_K + g_k) * U + s`` forward, ``(g_k, chunk, u)``
    order for the inverse (one copy), into ``out`` (the relocated rows'
    place in the round's output, shaped as ``y`` was) when given."""
    _wait(p)
    b, m_loc, c = p.shape
    moved = p.recv.movedim(0, 2) if p.inverse else p.recv.permute(1, 2, 3, 0, 4)
    if out is None:
        y = moved.reshape(b, m_loc, c)
        return y[0] if p.squeeze else y
    out3 = out[None] if p.squeeze else out
    out3.view(moved.shape).copy_(moved)
    return out


def _relocate_batched(y: torch.Tensor, q_prod: int, g_k: int, exchange: Exchange) -> torch.Tensor:
    """One relocation of a whole ``(B, M_loc, C)`` batch (2-D operands are
    its batch-of-one view): one all-to-all for the batch."""
    chaos.maybe_fail("collective")
    return _relocate_finish(_relocate_start(y, q_prod, g_k, exchange))


def _relocate_batched_t(y: torch.Tensor, q_prod: int, g_k: int, exchange: Exchange) -> torch.Tensor:
    """Transpose of ``_relocate_batched``, also its inverse; the backward
    rounds run it in place of the forward relocation."""
    return _relocate_finish(_relocate_start(y, q_prod, g_k, exchange, inverse=True))


def _relocate_slab(y, q_prod, g_k, exchange, n_slabs: int, *, inverse: bool = False) -> _Pending:
    """Issue the relocation of ONE slab.  Pipelined schedules (``n_slabs >
    1``) pass the ``slab_collective`` chaos site, so a test can fail one
    slab's collective and walk the slabbed -> serial -> local ladder; the
    forward relocation passes ``collective`` as well."""
    if n_slabs > 1:
        chaos.maybe_fail("slab_collective")
    if not inverse:
        chaos.maybe_fail("collective")
    return _relocate_start(y, q_prod, g_k, exchange, inverse=inverse)


def _drain(started: list[_Pending]) -> None:
    """Wait for every relocation already issued (a failure mid-round must
    not leave collectives in flight)."""
    for p in started:
        _wait(p)


def _slab_round(
    src: torch.Tensor,
    fs: tuple[torch.Tensor, ...],
    qprod: int,
    g_k: int,
    exchange: Exchange,
    backend: str,
    k: int,
    n: int,
    *,
    in_place: bool = False,
    record: bool = True,
) -> torch.Tensor:
    """One slab-scheduled round on the local rows ``src`` (``(M_loc, C)``,
    or ``(B, M_loc, C)`` per-sample), split into ``n`` row slabs: launch
    slab ``s``'s chain, issue its all-to-all, and only then wait for slab
    ``s-1``'s and move it into the round's output rows.  Slab ``s``'s
    exchange thus runs under slab ``s+1``'s chain, and at most two slabs'
    send and receive buffers are alive.  Rows are never communicated, so
    with ``in_place`` (``src`` is the previous round's output, owned by the
    schedule) a round of as many output as input columns writes each slab
    back over the rows its chain has read: no second stripe."""
    slabs = emit.split_slabs(src, n, axis=-2)
    if g_k <= 1:
        outs = [_local_multiply_round(s, fs, backend) for s in slabs]
        return outs[0] if n == 1 else torch.cat(outs, dim=-2)
    rows = int(src.shape[-2]) // n
    out = None
    shapes: list[tuple] = []
    inflight: list[_Pending] = []
    try:
        for s in range(n):
            y_s = [_local_multiply_round(slabs[s], fs, backend)]  # _relocate_start frees it
            shapes.append(tuple(int(d) for d in y_s[0].shape))
            if out is None:
                full = (*y_s[0].shape[:-2], rows * n, y_s[0].shape[-1])
                out = (src if in_place and tuple(src.shape) == full
                       else y_s[0].new_empty(full))
            inflight.append(_relocate_slab(y_s, qprod, g_k, exchange, n))
            if len(inflight) > 1:
                _relocate_finish(inflight[0], out.narrow(-2, (s - 1) * rows, rows))
                inflight.pop(0)
        _relocate_finish(inflight[0], out.narrow(-2, (n - 1) * rows, rows))
        inflight.clear()
    except BaseException:
        _drain(inflight)
        raise
    if record:
        _record_round_comm(shapes, g_k, k)
    return out


def _signature(factors_rev) -> tuple[list[int], list[int]]:
    return ([int(f.shape[-2]) for f in factors_rev], [int(f.shape[-1]) for f in factors_rev])


def _dist_body(
    x_loc: torch.Tensor,
    factors_rev: tuple[torch.Tensor, ...],
    *,
    g_k: int,
    exchange: Exchange,
    backend: str,
    per_iteration: bool,
    n_slabs: int,
    record: bool = True,
) -> torch.Tensor:
    """The one round loop behind both mesh runners: 2-D ``x_loc`` with
    shared 2-D factors, or per-sample 3-D ``x_loc`` and factors.  Every
    round runs the slab pipeline over ``n_slabs`` row slabs; the first
    writes a new stripe, each later one writes over its input where the
    widths agree, so a rank holds ``x_loc``, one stripe of the output and
    the slabs in flight (``round_working_set_bytes``)."""
    ps, qs = _signature(factors_rev)
    rounds = plan_rounds(int(x_loc.shape[-1]), ps, qs, g_k, minimal=per_iteration)
    n = emit.effective_slabs(int(x_loc.shape[-2]), n_slabs)
    batched = factors_rev[0].ndim == 3
    y = x_loc
    i = 0
    for k, r in enumerate(rounds):
        fs = tuple(factors_rev[i : i + r])
        qprod = math.prod(qs[i : i + r])
        with telemetry.span("round", k=k, n_factors=r, n_slabs=n, batched=batched):
            y = _slab_round(y, fs, qprod, g_k, exchange, backend, k, n, in_place=k > 0,
                            record=record)
        i += r
    return y


def round_working_set_bytes(
    m_loc: int, k_loc: int, ps: Sequence[int], qs: Sequence[int], g_k: int, *,
    n_slabs: int = 1, batch: int = 1, dtype_bytes: int = 4, per_iteration: bool = False,
) -> int:
    """Bytes one rank holds at the peak of the forward rounds (``_dist_body``)
    on its ``(batch, m_loc, k_loc)`` shard, factors in application order:
    ``x_loc``, the round's input and output stripes (one where a later
    round writes over its input), and the slabs in flight: a slab's chain
    input and output at the widest intermediate, and, pipelined, the
    previous slab's send and receive buffers.  An upper bound of what the
    caching allocator hands out (the factors and the kernels' scratch are
    left out).  Raises ``PlanError`` when no round schedule exists."""
    ps, qs = list(ps), list(qs)
    rounds = plan_rounds(k_loc, ps, qs, g_k, minimal=per_iteration)
    n = emit.effective_slabs(m_loc, n_slabs)
    row = batch * m_loc  # elements per column of a stripe
    slab = batch * (m_loc // n)
    peak = 0
    c = k_loc
    i = 0
    for k, r in enumerate(rounds):
        c_in = c
        widest = c
        for j in range(i, i + r):
            c = c // ps[j] * qs[j]
            widest = max(widest, c)
        stripes = k_loc + (0 if k == 0 else c_in) + (0 if k > 0 and c == c_in else c)
        if g_k <= 1:
            stripes = k_loc + c_in * (k > 0) + c * (2 if n > 1 else 1)
            inflight = 2 * slab * widest
        else:
            inflight = 2 * slab * widest + (2 * slab * c if n > 1 else 0)
        if batch > 1 and n > 1:
            inflight += slab * c_in  # a per-sample slab's input made contiguous
        peak = max(peak, row * stripes + inflight)
        i += r
    return peak * dtype_bytes


class _Rows:
    """A full-rows tensor assembled from its ``n`` row slabs as they come:
    the concatenation, without holding every slab and its copy at once."""

    def __init__(self, n: int):
        self.n = n
        self.full = None

    def put(self, s: int, t: torch.Tensor) -> None:
        if self.n == 1:
            self.full = t
            return
        rows = int(t.shape[-2])
        if self.full is None:
            self.full = t.new_empty((*t.shape[:-2], rows * self.n, t.shape[-1]))
        self.full.narrow(-2, s * rows, rows).copy_(t)


def _dist_body_bwd(
    x_loc: torch.Tensor,
    factors_rev: tuple[torch.Tensor, ...],
    g: torch.Tensor,
    *,
    g_k: int,
    exchange: Exchange,
    backend: str,
    per_iteration: bool,
    n_slabs: int,
    factors: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...] | None]:
    """Backward of ``_dist_body`` with the same slab pipeline in reverse:
    per round, slab ``s+1``'s inverse all-to-all is issued before slab
    ``s``'s transposed multiplies run.  Returns dx and, with ``factors``,
    this rank's partial factor gradients in the accumulator dtype (in
    ``factors_rev`` order; the caller sums them over the mesh).

    With ``factors`` the round inputs are re-materialised from ``x_loc``
    (the forward rounds but the last, telemetry off: the ``_program_bwd``
    idiom) and, inside a round, by one ``sliced`` multiply per factor but
    the last.  Each factor gradient is ONE full-row contraction over the
    concatenated slab inputs and cotangents, so slabbed and serial
    gradients are bitwise equal.  dx alone needs neither."""
    from .engine import _sliced_batched, _sliced_t_batched, _sliced_vjp_factor

    ps, qs = _signature(factors_rev)
    rounds = plan_rounds(int(x_loc.shape[-1]), ps, qs, g_k, minimal=per_iteration)
    n = emit.effective_slabs(int(x_loc.shape[-2]), n_slabs)
    meta: list[tuple[int, tuple, int]] = []
    per_round_in: list[torch.Tensor | None] = []
    cur = x_loc if factors else None
    i = 0
    for k, r in enumerate(rounds):
        fs = tuple(factors_rev[i : i + r])
        qprod = math.prod(qs[i : i + r])
        meta.append((i, fs, qprod))
        per_round_in.append(cur)
        if factors and k + 1 < len(rounds):
            cur = _slab_round(cur, fs, qprod, g_k, exchange, backend, k, n, record=False)
        i += r

    dfs: list[torch.Tensor | None] = [None] * len(factors_rev)
    g_slabs = emit.split_slabs(g, n, axis=-2)
    batched = factors_rev[0].ndim == 3
    for k in reversed(range(len(rounds))):
        i0, fs, qprod = meta[k]
        with telemetry.span("round_bwd", k=k, n_factors=len(fs), n_slabs=n, batched=batched):
            in_slabs = emit.split_slabs(per_round_in[k], n, axis=-2) if factors else None
            inp = [_Rows(n) for _ in fs]
            cot = [_Rows(n) for _ in fs]
            new_g: list[torch.Tensor | None] = [None] * n
            started: list[_Pending] = []
            try:
                if g_k > 1:
                    started.append(_relocate_slab(g_slabs[0], qprod, g_k, exchange, n,
                                                  inverse=True))
                for s in range(n):
                    # Issue slab s+1's inverse relocation first, then retire
                    # slab s's transposed multiplies: the mirror of _slab_round.
                    if g_k > 1 and s + 1 < n:
                        started.append(_relocate_slab(g_slabs[s + 1], qprod, g_k, exchange,
                                                      n, inverse=True))
                    gg = _relocate_finish(started[s]) if g_k > 1 else g_slabs[s]
                    if factors:
                        ins = [in_slabs[s]]
                        for f in fs[:-1]:
                            ins.append(_sliced_batched(ins[-1], f, backend))
                    for idx in reversed(range(len(fs))):
                        if factors:
                            inp[idx].put(s, ins[idx])
                            cot[idx].put(s, gg)
                        gg = _sliced_t_batched(gg, fs[idx], backend)
                    new_g[s] = gg
            except BaseException:
                _drain(started)
                raise
            if factors:
                for idx, f in enumerate(fs):
                    dfs[i0 + idx] = _sliced_vjp_factor(
                        inp[idx].full, cot[idx].full, int(f.shape[-2]), int(f.shape[-1]))
                    inp[idx] = cot[idx] = None
            per_round_in[k] = in_slabs = None
            g_slabs = new_g
    dx = g_slabs[0] if n == 1 else torch.cat(g_slabs, dim=-2)
    return dx.to(x_loc.dtype), (tuple(dfs) if factors else None)


# ---------------------------------------------------------------------------
# The autograd.Function and the mesh plumbing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _RoundCfg:
    """A round schedule's static configuration: the model axis's exchange,
    the function that sums factor gradients over the mesh (in place on one
    flat buffer), and the body's options."""

    g_k: int
    exchange: Exchange
    reduce: Callable[[torch.Tensor], None]
    backend: str
    per_iteration: bool
    n_slabs: int

    def body(self) -> dict:
        return dict(g_k=self.g_k, exchange=self.exchange, backend=self.backend,
                    per_iteration=self.per_iteration, n_slabs=self.n_slabs)


def _sum_grads(dfs: Sequence[torch.Tensor], reduce) -> list[torch.Tensor]:
    """Sum each rank's partial factor gradients over the mesh: one flat
    buffer, reduced in place (one collective per data or model dim for
    all)."""
    flat = torch.cat([d.reshape(-1) for d in dfs])
    reduce(flat)
    return [t.view_as(d) for t, d in zip(torch.split(flat, [d.numel() for d in dfs]), dfs)]


class _Rounds(torch.autograd.Function):
    """The round schedule on each rank's local shard: forward ``_dist_body``,
    backward ``_dist_body_bwd`` with the factor gradients summed over the
    mesh.  The residuals are ``x_loc`` and the factors."""

    @staticmethod
    def forward(ctx, x_loc, cfg: _RoundCfg, *factors_rev):
        ctx.cfg = cfg
        ctx.save_for_backward(x_loc, *factors_rev)
        return _dist_body(x_loc, factors_rev, **cfg.body())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x_loc, *factors_rev = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        dx, dfs = _dist_body_bwd(
            x_loc, tuple(factors_rev), g.contiguous(), factors=any(need), **ctx.cfg.body()
        )
        if dfs is None:
            dfs = (None,) * len(factors_rev)
        else:
            dfs = [d.to(f.dtype) if want else None
                   for d, f, want in zip(_sum_grads(dfs, ctx.cfg.reduce), factors_rev, need)]
        return (dx if ctx.needs_input_grad[0] else None, None, *dfs)


def _axes(axis) -> tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _mesh_size(mesh, axis) -> int:
    """Ranks along one mesh dim, or the product over a tuple of dims."""
    names = mesh.mesh_dim_names
    return math.prod(int(mesh.shape[names.index(a)]) for a in _axes(axis))


def mesh_placements(mesh, data_axis="data", model_axis="model", *, ndim: int = 2) -> tuple:
    """Placements of an ``(..., M, K)`` operand on ``mesh``: rows (dim
    ``ndim-2``) over ``data_axis``, columns over ``model_axis``, every other
    mesh dim replicated."""
    data = _axes(data_axis)
    out = []
    for name in mesh.mesh_dim_names:
        if name in data:
            out.append(Shard(ndim - 2))
        elif name == model_axis:
            out.append(Shard(ndim - 1))
        else:
            out.append(Replicate())
    return tuple(out)


def _mesh_reduce(mesh, data_axis, model_axis) -> Callable[[torch.Tensor], None]:
    """Sum over the dims that split the problem (``data_axis`` and
    ``model_axis``) only: a rank along any other (replicated) dim holds the
    same partial, which the reference's ``shard_map`` does not count twice."""
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in (*_axes(data_axis), model_axis)]

    def reduce(t: torch.Tensor) -> None:
        for d in dims:
            if int(mesh.shape[d]) > 1:
                dist.all_reduce(t, group=mesh.get_group(d))

    return reduce


# Moving between a full tensor and its shards goes through the two
# autograd.Functions below, which call ``torch.distributed`` collectives
# directly: DTensor's own redistribution (its functional all-gather) crashes
# under gloo with CUDA tensors in torch 2.11, the configuration that runs
# several ranks on one card.


# ``all_gather_single`` replaces ``all_gather_into_tensor`` in newer torch.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _shard_dims(mesh, placements) -> list[tuple[int, int]]:
    """(mesh dim, tensor dim) of every ``Shard`` placement."""
    return [(d, p.dim) for d, p in enumerate(placements) if isinstance(p, Shard)]


def _slice_local(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` (mesh dim 0 outermost, as DTensor lays
    out several mesh dims on one tensor dim)."""
    coord = mesh.get_coordinate()
    out = full
    for d, td in _shard_dims(mesh, placements):
        n = int(mesh.shape[d])
        size = int(out.shape[td]) // n
        out = out.narrow(td, coord[d] * size, size)
    return out


def _gather_full(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The full tensor from every rank's shard: one ``all_gather_into_tensor``
    per sharded mesh dim, innermost first."""
    out = local
    for d, td in reversed(_shard_dims(mesh, placements)):
        n = int(mesh.shape[d])
        src = out.movedim(td, 0).contiguous()
        buf = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
        _all_gather(buf, src, group=mesh.get_group(d))
        out = buf.movedim(0, td)
    return out.contiguous()


class _Slice(torch.autograd.Function):
    """Full tensor -> this rank's shard; backward gathers the gradient."""

    @staticmethod
    def forward(ctx, full, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return _slice_local(full, mesh, placements).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_full(g.contiguous(), ctx.mesh, ctx.placements), None, None


class _Gather(torch.autograd.Function):
    """This rank's shard -> the full tensor; backward slices the gradient."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return _gather_full(local, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return _slice_local(g, ctx.mesh, ctx.placements).contiguous(), None, None


def _from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def gather(y: DTensor) -> torch.Tensor:
    """The full tensor of a DTensor on every rank (an all-gather per sharded
    mesh dim; differentiable: the backward keeps each rank's slice)."""
    return _Gather.apply(y.to_local(), y.device_mesh, tuple(y.placements))


def _as_placed(x: torch.Tensor, mesh, placements) -> DTensor:
    """``x`` on ``mesh`` at ``placements``: a DTensor is redistributed if
    placed otherwise; a plain tensor is taken as the full array every rank
    holds and sliced locally (no communication; differentiable, the
    backward gathers the gradient)."""
    if isinstance(x, DTensor):
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(mesh, placements)
        return x
    return _from_local(_Slice.apply(x, mesh, tuple(placements)), mesh, placements, x.shape)


def _local_factor(f: torch.Tensor) -> torch.Tensor:
    return f.to_local() if isinstance(f, DTensor) else f


def _run(x, factors, mesh, *, data_axis, model_axis, backend, per_iteration, n_slabs,
         per_sample: bool) -> DTensor:
    factors = tuple(factors)
    placements = mesh_placements(mesh, data_axis, model_axis, ndim=x.ndim)
    xd = _as_placed(x, mesh, placements)
    x_loc = xd.to_local()
    fs = tuple(_local_factor(f) for f in factors)
    g_k = _mesh_size(mesh, model_axis)
    cfg = _RoundCfg(
        g_k, group_exchange(mesh.get_group(model_axis)),
        _mesh_reduce(mesh, data_axis, model_axis), backend, bool(per_iteration), int(n_slabs),
    )
    lead = x_loc.shape[:-1]
    if not per_sample:
        # Shared factors: every leading axis is rows of one problem.
        x_loc = x_loc.reshape(-1, x_loc.shape[-1])
    y_loc = _Rounds.apply(x_loc, cfg, *reversed(fs))
    y_loc = y_loc.reshape(*lead, y_loc.shape[-1])
    return _from_local(y_loc, mesh, placements, (*xd.shape[:-1], int(y_loc.shape[-1]) * g_k))


# ---------------------------------------------------------------------------
# Mesh runners (the engine's distributed execution layer) and the shims
# ---------------------------------------------------------------------------


def run_distributed_rounds(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mesh,
    *,
    data_axis: str | tuple[str, ...] = "data",
    model_axis: str = "model",
    backend: str = "auto",
    per_iteration: bool = False,
    n_slabs: int = 1,
) -> DTensor:
    """Distributed ``x @ (F^1 (x) ... (x) F^N)`` on a ``(data, model)``
    DeviceMesh: the round schedule the ``KronOp`` mesh path runs.

    ``x``: an ``(M, K)`` DTensor placed ``mesh_placements(...)`` (rows over
    ``data_axis``, columns over ``model_axis``; a ``(B, M, K)`` one folds B
    into the local rows, the shared-factor batch), or a plain tensor every
    rank holds in full (sliced locally).  Factors are replicated.  Returns
    the product as a DTensor with x's placements.  ``per_iteration=True``
    relocates after every factor (the CTF/DISTAL baseline); ``n_slabs > 1``
    pipelines each round's all-to-all under the next row slab's chain
    (bitwise equal output, clamped to divisors of the local row count)."""
    return _run(x, factors, mesh, data_axis=data_axis, model_axis=model_axis, backend=backend,
                per_iteration=per_iteration, n_slabs=n_slabs, per_sample=False)


def run_batched_distributed_rounds(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mesh,
    *,
    t_b: int = 1,
    data_axis: str | tuple[str, ...] = "data",
    model_axis: str = "model",
    backend: str = "auto",
    per_iteration: bool = False,
    n_slabs: int = 1,
) -> DTensor:
    """Per-sample batched distributed rounds (``shared_factors=False``).

    ``x``: ``(B, M, K)`` placed ``(Shard(1), Shard(2))`` on ``(data,
    model)``; factors ``(B, P_i, Q_i)`` replicated.  Each round's local
    multiplies are per-sample chain launches and each round's relocation
    is ONE all-to-all moving the ``(B, M_loc, C_loc)`` slab.  ``t_b`` is
    the reference's batch tile, accepted for its signature: the card's
    chain kernels walk one sample per tile, so no launch reads it."""
    del t_b
    factors = tuple(factors)
    if x.ndim != 3:
        raise ValueError(f"x must be (B, M, K), got shape {tuple(x.shape)}")
    if any(f.ndim != 3 for f in factors):
        raise ValueError("expects 3-D (B, P_i, Q_i) per-sample factors")
    b = int(x.shape[0])
    for f in factors:
        if int(f.shape[0]) != b:
            raise ValueError(f"factor batch {f.shape[0]} != x batch {b}")
    return _run(x, factors, mesh, data_axis=data_axis, model_axis=model_axis, backend=backend,
                per_iteration=per_iteration, n_slabs=n_slabs, per_sample=True)


def kron_matmul_distributed(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mesh,
    *,
    data_axis: str | tuple[str, ...] = "data",
    model_axis: str = "model",
    backend: str = "auto",
    per_iteration: bool = False,
) -> torch.Tensor:
    """DEPRECATED shim over ``KronOp(ps, qs, mesh=mesh)``: distributed
    Kron-Matmul on a (data, model) mesh (see ``run_distributed_rounds``)."""
    from . import engine

    engine.warn_deprecated("kron_matmul_distributed", "KronOp(ps, qs, mesh=mesh)")
    factors = tuple(factors)
    ps, qs = engine.signature_of(factors, shared_factors=True)
    op = engine.kron_op_for(
        ps, qs, mesh=mesh, data_axis=_axes_key(data_axis), model_axis=model_axis,
        backend=backend, per_iteration=per_iteration,
    )
    return op(x, factors)


def kron_matmul_batched_distributed(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mesh,
    *,
    shared_factors: bool,
    data_axis: str | tuple[str, ...] = "data",
    model_axis: str = "model",
    backend: str = "auto",
    per_iteration: bool = False,
    plan="auto",
) -> torch.Tensor:
    """DEPRECATED shim over ``KronOp(ps, qs, batch=B, shared_factors=...,
    mesh=mesh)``: ``B`` distributed Kron-Matmuls with one collective round
    per stage for the whole batch.  ``x``: ``(B, M, K)`` placed
    ``(Shard(1), Shard(2))`` (``sharded_input_batched``)."""
    from . import engine

    engine.warn_deprecated(
        "kron_matmul_batched_distributed",
        "KronOp(ps, qs, batch=B, shared_factors=..., mesh=mesh)",
    )
    factors = tuple(factors)
    if x.ndim != 3:
        raise ValueError(f"x must be (B, M, K), got shape {tuple(x.shape)}")
    ps, qs = engine.signature_of(factors, shared_factors=shared_factors)
    op = engine.kron_op_for(
        ps, qs, batch=int(x.shape[0]), shared_factors=shared_factors, mesh=mesh,
        data_axis=_axes_key(data_axis), model_axis=model_axis, backend=backend,
        per_iteration=per_iteration, plan=plan,
    )
    return op(x, factors)


def _axes_key(axis):
    # kron_op_for is an lru_cache: a list of axis names becomes a tuple.
    return tuple(axis) if isinstance(axis, list) else axis


def sharded_input(x, mesh, data_axis="data", model_axis="model", *, src_data_rank=None):
    """Place ``(M, K)`` onto the grid the distributed rounds expect: rows
    over ``data_axis``, columns over ``model_axis``.  Every rank passes the
    same full ``x``, as SPMD code does, and keeps its slice
    (``src_data_rank=None``: no communication); ``src_data_rank=r`` sends
    rank r's instead."""
    return distribute_tensor(x, mesh, mesh_placements(mesh, data_axis, model_axis, ndim=2),
                             src_data_rank=src_data_rank)


def sharded_input_from_local(x_loc: torch.Tensor, mesh, data_axis="data", model_axis="model"):
    """Place this rank's own shard as the distributed rounds' input, for a
    problem no rank holds whole: ``x_loc`` is ``(M/G_M, K/G_K)`` (``(B,
    M/G_M, K/G_K)`` for a batched op), the block at this rank's mesh
    coordinates (rows over ``data_axis``, columns over ``model_axis``),
    and every rank's has the same shape.  No communication and no copy:
    the DTensor wraps ``x_loc``, and its global shape is the shard's scaled
    by the mesh."""
    if x_loc.ndim not in (2, 3):
        raise ValueError(f"x_loc must be (M, K) or (B, M, K), got shape {tuple(x_loc.shape)}")
    placements = mesh_placements(mesh, data_axis, model_axis, ndim=x_loc.ndim)
    shape = (*x_loc.shape[:-2], int(x_loc.shape[-2]) * _mesh_size(mesh, data_axis),
             int(x_loc.shape[-1]) * _mesh_size(mesh, model_axis))
    return _from_local(x_loc, mesh, placements, shape)


def sharded_input_batched(x, mesh, data_axis="data", model_axis="model", *,
                          src_data_rank=None):
    """Place ``(B, M, K)``: batch replicated, rows over ``data_axis``,
    columns over ``model_axis`` (``src_data_rank`` as in
    ``sharded_input``)."""
    return distribute_tensor(x, mesh, mesh_placements(mesh, data_axis, model_axis, ndim=3),
                             src_data_rank=src_data_rank)


__all__ = [
    "kron_matmul_distributed",
    "kron_matmul_batched_distributed",
    "run_distributed_rounds",
    "run_batched_distributed_rounds",
    "plan_rounds",
    "comm_elems_per_device",
    "comm_hidden_elems",
    "sharded_input",
    "sharded_input_from_local",
    "sharded_input_batched",
    "round_working_set_bytes",
    "mesh_placements",
    "group_exchange",
    "gather",
]
