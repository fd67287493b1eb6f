"""StageProgram IR and the executor behind every planned Kron-Matmul path.

The port of ``repro.kernels.emit``:

* a ``StageInstr`` is one kernel launch, typed ``multiply`` /
  ``transposed_multiply`` / ``prekron`` and carrying everything the executor
  needs (``ps, qs, t_m, t_k, t_qs, t_b, direction, acc_dtype``).  ``t_b=None``
  means *unbatched*: batch is a leading axis of size one, not a separate code
  path.
* a ``StageProgram`` is a tuple of instructions; ``transpose(prog)`` derives
  the backward program mechanically.
* ``run_stage`` / ``run_program`` / ``emit`` execute instructions of either
  direction; ``run_stage_grad`` runs one stage's full backward (dx and the
  factor gradients).  On CUDA tensors each is ONE launch of a hand-written
  kernel: the forward chain (``chain_cuda``, ``csrc/chain_fwd.cu``), the
  transposed chain (``chain_bwd_cuda``, ``csrc/chain_bwd.cu``) or the stage
  backward (``grad_cuda``, ``csrc/grad.cu``, plus its dF reduction launch).
  On CPU tensors, or with ``backend="torch"`` on either device, they run
  the kernels' plain twins ``chain_reference``, ``chain_bwd_reference`` and
  ``grad_reference``.  There is no fallback between the two: the backend
  (by default the tensors' device) decides.  The guard layer's hooks sit at
  the reference's points: the ``stage_execute`` and ``pallas_lowering``
  chaos sites, ``check_finite`` on ``run_stage_grad``'s dx and
  ``run_program``'s output, and the ``stage``, ``stage_grad`` and
  ``program`` telemetry spans.
* every CUDA launcher reports its launch's FLOPs (``chain_flops``) and HBM
  bytes (inputs, factors, outputs) to the active ``hlo_cost.CostMode``s,
  and on a ``FakeTensor`` (a dry-run's trace) returns its output without a
  build, an occupancy query or a launch, and counts no launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..runtime import chaos, guard, hlo_cost, telemetry
from ..runtime.guard import LoweringError, VmemOverflowError
from . import _build

# Shared memory one block may hold on an H100: 227 KB of the SM's 256 KB
# (232,448 bytes, opt-in above 48 KB).  The planner's per-stage budget is
# that many f32 elements, in place of the TPU's VMEM budget
# (repro.kernels.emit.VMEM_BUDGET_ELEMS = 2M elements = 8 MiB); the kernel
# then picks its own block tile inside the plan's (t_m, t_k).
SMEM_BYTES = 232448
SMEM_BUDGET_ELEMS = SMEM_BYTES // 4  # 58,112

MULTIPLY = "multiply"
TRANSPOSED_MULTIPLY = "transposed_multiply"
PREKRON = "prekron"
_KINDS = (MULTIPLY, TRANSPOSED_MULTIPLY, PREKRON)

# Launch counters, +1 per CUDA launch and nowhere else: the forward chain,
# the transposed chain, the stage backward and its dF reduction.
chain_launches = 0
chain_bwd_launches = 0
grad_launches = 0
grad_reduce_launches = 0

_MAX_FACTORS = 16  # kron::kMaxFactors in csrc/kron_tile.cuh
_KERNEL_DTYPES = {  # (input dtype, acc dtype) -> code in csrc/kron_tile.cuh
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """``"auto"`` picks by the tensor's device: ``"cuda"`` (the kernels) for
    a CUDA tensor, ``"torch"`` (the plain twins) for a CPU one.
    ``"torch"`` runs the twins on either device, as the reference's explicit
    ``"xla"`` runs anywhere; ``"cuda"`` needs CUDA tensors and raises
    ``ValueError`` on CPU ones."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda":
        if not x.is_cuda:
            raise ValueError(f"backend='cuda' needs CUDA tensors, got {x.device}")
        return backend
    if backend == "torch":
        return backend
    raise ValueError(f"unknown backend {backend!r}: 'auto', 'cuda' or 'torch'")


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation for <=f32 inputs, f64 for f64 (never truncate)."""
    return torch.promote_types(dtype, torch.float32)


def _resolve_acc(acc_dtype: str | None, dtype: torch.dtype) -> torch.dtype:
    if acc_dtype is None:
        return acc_dtype_for(dtype)
    acc = getattr(torch, acc_dtype, None)
    if not isinstance(acc, torch.dtype):
        raise LoweringError(f"unknown acc_dtype {acc_dtype!r}")
    return acc


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageInstr:
    """One kernel launch of a stage program.

    ``ps``/``qs`` are the per-chained-factor dims in APPLICATION order (the
    factor applied first is entry 0).  ``kind`` selects the data flow:
    ``multiply`` chains sliced multiplies, ``transposed_multiply`` un-applies
    them (the input cotangent), ``prekron`` first combines the stage's
    factors into their explicit Kronecker product and applies it as one
    sliced multiply (forward or transposed per ``direction``).

    Tiling: ``t_m`` rows, ``t_k`` input columns (a multiple of ``prod(ps)``;
    None = full), ``t_qs`` per-factor Q-tiles, ``t_b`` samples per block —
    ``t_b=None`` means unbatched, executed as a batch of one.
    ``acc_dtype`` (a dtype name, e.g. ``"float32"``) is this stage's
    accumulation dtype; None promotes the input dtype against f32.
    ``t_m_bwd`` is the planner's tuned M-tile for the transposed instruction;
    ``transpose()`` swaps it in mechanically.
    """

    kind: str
    ps: tuple[int, ...]
    qs: tuple[int, ...]
    factor_ids: tuple[int, ...] = ()
    t_m: int = 8
    t_k: int | None = None
    t_qs: tuple[int, ...] | None = None
    t_b: int | None = None
    direction: str = "fwd"
    acc_dtype: str | None = None
    t_m_bwd: int | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown stage kind {self.kind!r}")
        if self.direction not in ("fwd", "bwd"):
            raise ValueError(f"unknown direction {self.direction!r}")
        if len(self.ps) != len(self.qs) or not self.ps:
            raise ValueError(f"ps/qs must be equal-length, non-empty: {self}")
        # kind implies direction for the non-prekron instructions.
        if self.kind == MULTIPLY and self.direction != "fwd":
            object.__setattr__(self, "direction", "fwd")
        if self.kind == TRANSPOSED_MULTIPLY and self.direction != "bwd":
            object.__setattr__(self, "direction", "bwd")

    @property
    def pprod(self) -> int:
        return math.prod(self.ps)

    @property
    def qprod(self) -> int:
        return math.prod(self.qs)

    @property
    def batched(self) -> bool:
        return self.t_b is not None

    def transpose(self) -> "StageInstr":
        """The instruction computing this instruction's input cotangent."""
        if self.kind == PREKRON:
            kind = PREKRON
            direction = "bwd" if self.direction == "fwd" else "fwd"
        elif self.kind == MULTIPLY:
            kind, direction = TRANSPOSED_MULTIPLY, "bwd"
        else:
            kind, direction = MULTIPLY, "fwd"
        return dataclasses.replace(
            self,
            kind=kind,
            direction=direction,
            t_m=self.t_m_bwd if self.t_m_bwd is not None else self.t_m,
            t_m_bwd=self.t_m,
        )

    def describe(self) -> str:
        tag = f"{self.kind}[{list(self.ps)}x{list(self.qs)}]@(t_m={self.t_m},t_k={self.t_k}"
        if self.t_qs is not None:
            tag += f",t_qs={list(self.t_qs)}"
        if self.t_b is not None:
            tag += f",t_b={self.t_b}"
        if self.acc_dtype is not None:
            tag += f",acc={self.acc_dtype}"
        return tag + ")"


@dataclasses.dataclass(frozen=True)
class StageProgram:
    """A planner-emitted sequence of stage instructions.

    ``factor_ids`` on each instruction index into the REVERSED (application
    order) factor list of an ``n_factors``-long chain; ``run_program`` /
    ``emit`` take factors in PROBLEM order and reverse internally.
    """

    instrs: tuple[StageInstr, ...]
    n_factors: int

    def __post_init__(self):
        seen = [i for ins in self.instrs for i in ins.factor_ids]
        if sorted(seen) != list(range(self.n_factors)):
            raise ValueError(
                f"program instrs must cover factors 0..{self.n_factors - 1} "
                f"exactly once, got {seen}"
            )

    @property
    def batched(self) -> bool:
        return any(ins.batched for ins in self.instrs)

    def describe(self) -> str:
        return " -> ".join(ins.describe() for ins in self.instrs)


def transpose(prog: StageProgram) -> StageProgram:
    """The backward program: reversed instructions, each transposed."""
    return StageProgram(
        tuple(ins.transpose() for ins in reversed(prog.instrs)), prog.n_factors
    )


# ---------------------------------------------------------------------------
# Plain primitive bodies
# ---------------------------------------------------------------------------


def sliced_apply(
    y: torch.Tensor, f: torch.Tensor, acc_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """One FastKron sliced multiply, batch-polymorphic, rounded to y's dtype.

    ``y: (M, S*P)`` with ``f: (P, Q)`` -> ``(M, Q*S)``; or ``y: (B, M, S*P)``
    with per-sample ``f: (B, P, Q)`` -> ``(B, M, Q*S)``.  A 3-D ``y`` with a
    shared 2-D ``f`` folds the batch into rows.
    """
    acc = acc_dtype_for(y.dtype) if acc_dtype is None else acc_dtype
    if f.ndim == 2:
        if y.ndim == 3:
            b, m, k = y.shape
            return sliced_apply(y.reshape(b * m, k), f, acc).reshape(b, m, -1)
        m, k = y.shape
        p, q = f.shape
        s = k // p
        out = y.reshape(m * s, p).to(acc) @ f.to(acc)
        return out.reshape(m, s, q).transpose(1, 2).reshape(m, q * s).to(y.dtype)
    b, m, k = y.shape
    p, q = int(f.shape[1]), int(f.shape[2])
    s = k // p
    out = torch.bmm(y.reshape(b, m * s, p).to(acc), f.to(acc))
    return out.reshape(b, m, s, q).transpose(2, 3).reshape(b, m, q * s).to(y.dtype)


def sliced_apply_t(
    g: torch.Tensor, f: torch.Tensor, acc_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Transposed sliced multiply (the input cotangent), batch-polymorphic,
    rounded to g's dtype.

    ``g: (M, Q*S)`` with ``f: (P, Q)`` -> ``(M, S*P)``; batched analogue with
    3-D ``g``/``f`` as in ``sliced_apply``.
    """
    acc = acc_dtype_for(g.dtype) if acc_dtype is None else acc_dtype
    if f.ndim == 2:
        if g.ndim == 3:
            b, m, l = g.shape
            return sliced_apply_t(g.reshape(b * m, l), f, acc).reshape(b, m, -1)
        m, l = g.shape
        p, q = f.shape
        s = l // q
        g2 = g.reshape(m, q, s).transpose(1, 2).reshape(m * s, q).to(acc)
        return (g2 @ f.to(acc).T).reshape(m, s * p).to(g.dtype)
    b, m, l = g.shape
    p, q = int(f.shape[1]), int(f.shape[2])
    s = l // q
    g2 = g.reshape(b, m, q, s).transpose(2, 3).reshape(b, m * s, q).to(acc)
    out = torch.bmm(g2, f.to(acc).transpose(1, 2))
    return out.reshape(b, m, s * p).to(g.dtype)


def sliced_vjp_factor(
    u: torch.Tensor, g: torch.Tensor, p: int, q: int, acc_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The factor cotangent of one sliced multiply, batch-polymorphic:
    ``df[..., p, q] = sum_{m,s} u[..., m, s*P+p] g[..., m, q*S+s]``, in the
    accumulator dtype (f32, f64 for f64) — per sample for 3-D operands."""
    acc = acc_dtype_for(g.dtype) if acc_dtype is None else acc_dtype
    s = int(u.shape[-1]) // p
    u4 = u.reshape(*u.shape[:-1], s, p).to(acc)
    g4 = g.reshape(*g.shape[:-1], q, s).to(acc)
    return torch.einsum("...msp,...mqs->...pq", u4, g4)


def prekron_product(stage_factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Explicit Kronecker product of a stage's factors, batch-polymorphic.

    ``stage_factors`` are in APPLICATION order (rev[i], rev[i+1], ...); the
    explicit product is formed in PROBLEM order, kron(rev[i+1], rev[i]):
    ``x @ (A (x) B)`` applies B first.  Per-sample 3-D factors take the
    Kronecker product of each sample's pair.
    """
    stage_factors = tuple(stage_factors)
    f = stage_factors[-1]
    for g in reversed(stage_factors[:-1]):
        if f.ndim == 2:
            f = torch.kron(f, g)
        else:
            b, pa, qa = f.shape
            pb, qb = g.shape[1], g.shape[2]
            f = (f[:, :, None, :, None] * g[:, None, :, None, :]).reshape(
                b, pa * pb, qa * qb
            )
    return f


# ---------------------------------------------------------------------------
# Slab-sliced execution (the distributed round pipeline's view of a program)
# ---------------------------------------------------------------------------


def effective_slabs(size: int, n_slabs: int) -> int:
    """Clamp a requested slab count to what the axis can carry: the largest
    divisor of ``size`` that is ``<= n_slabs``.  Slabs tile the axis
    exactly: a ragged tail slab would change the per-slab payload and break
    the comm accounting (per-slab all-to-all payloads sum to the serial
    total).  ``n_slabs <= 1`` and ``size == 0`` give 1, the serial
    schedule."""
    n = max(1, min(int(n_slabs), int(size) if size else 1))
    while size % n:
        n -= 1
    return n


def split_slabs(y: torch.Tensor, n_slabs: int, axis: int = 0) -> list[torch.Tensor]:
    """Split ``y`` into ``n_slabs`` equal slabs along ``axis``.

    The slabs partition a row-parallel axis, so running a chain per slab
    and concatenating is bitwise equal to the unsliced run: the property
    the slab-pipelined mesh rounds rely on.  The slabs are views of ``y``
    (``torch.split``): a caller reads them and writes none of them.
    Callers clamp with ``effective_slabs`` first; a count that does not
    divide the axis raises ``ValueError``."""
    size = int(y.shape[axis])
    if n_slabs <= 1:
        return [y]
    if size % n_slabs:
        raise ValueError(
            f"n_slabs={n_slabs} does not divide axis {axis} of size {size}; "
            f"clamp with effective_slabs first"
        )
    return list(torch.split(y, size // n_slabs, dim=axis))


# ---------------------------------------------------------------------------
# Growth models (shared by the executor and the planner)
# ---------------------------------------------------------------------------


def fused_growth(
    ps: Sequence[int], qs: Sequence[int], t_qs: Sequence[int] | None = None
) -> float:
    """Max live-set multiplier over chain prefixes, with optional Q-tiling."""
    t_qs = tuple(t_qs) if t_qs is not None else tuple(qs)
    g = 1.0
    pprod = qprod = 1
    for p, tq in zip(ps, t_qs):
        pprod *= p
        qprod *= tq
        g = max(g, qprod / pprod)
    return g


def transposed_growth(
    ps: Sequence[int], qs: Sequence[int], t_qs: Sequence[int] | None = None
) -> float:
    """Max live-set multiplier of the inverse chain, relative to T_K."""
    t_qs = tuple(t_qs) if t_qs is not None else tuple(qs)
    pprod = math.prod(ps)
    cols = math.prod(t_qs) / pprod  # in units of t_k
    g = max(1.0, cols)
    for p, tq in zip(reversed(tuple(ps)), reversed(t_qs)):
        cols = cols / tq * p
        g = max(g, cols)
    return g


def max_n_fused(t_k: int, p: int) -> int:
    """Paper: N_fused = floor(log_P T_K)."""
    n = 0
    while t_k >= p and t_k % p == 0:
        t_k //= p
        n += 1
    return n


# ---------------------------------------------------------------------------
# The chain kernel: tile checks, block geometry, wrapper and plain twin
# ---------------------------------------------------------------------------


def _divisors(n: int) -> list[int]:
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    return sorted(set(small + [n // d for d in small]))


@dataclasses.dataclass(frozen=True)
class ChainGeometry:
    """A chain instruction's checked dims, the kernel's block tile and the
    length of its persistent walk."""

    b: int
    m: int
    k: int  # x's columns (forward) or dX's (transposed)
    ps: tuple[int, ...]
    qs: tuple[int, ...]
    t_qs: tuple[int, ...]
    block_m: int  # t_m': rows per block, divides the instruction's t_m
    block_k: int  # t_k': input columns per block, divides t_k
    direction: str  # "fwd" (chain_fwd.cu) or "bwd" (chain_bwd.cu)

    @property
    def out_cols(self) -> int:
        return math.prod(self.qs) * (self.k // math.prod(self.ps))

    @property
    def q_tiles(self) -> int:
        return math.prod(q // t for q, t in zip(self.qs, self.t_qs))

    @property
    def tiles(self) -> int:
        """Tiles of the kernel's walk (``chain_walk``): (sample, Q-tile
        digits, row tile, column tile) forward; the transposed chain loops
        over the Q-tile digits inside each (sample, row, column) tile."""
        per = self.b * (self.m // self.block_m) * (self.k // self.block_k)
        return per * self.q_tiles if self.direction == "fwd" else per


def chain_walk(block: int, nblk: int, tiles: int) -> range:
    """The tiles block ``block`` of a persistent chain launch of ``nblk``
    blocks takes, in order (``chain_fwd.cu``, ``chain_bwd.cu``): every
    ``nblk``-th from its own index on, none when it has no tile."""
    return range(block, tiles, nblk)


def chain_tile_coords(geo: ChainGeometry, tile: int) -> tuple[int, int, int, int]:
    """(sample, composite Q-tile digit, row tile, column tile) of tile
    ``tile`` of ``geo``'s walk; the transposed chain's digit is always 0
    (it loops over the digits itself).  Tiles of one (sample, digit) are
    consecutive, so a block's panels change only at their boundaries."""
    k_tiles, m_tiles = geo.k // geo.block_k, geo.m // geo.block_m
    kt, rest = tile % k_tiles, tile // k_tiles
    mt, group = rest % m_tiles, rest // m_tiles
    q_tiles = geo.q_tiles if geo.direction == "fwd" else 1
    return group // q_tiles, group % q_tiles, mt, kt


_KINDS_SMEM = ("chain_fwd", "chain_bwd", "grad")
# Shared memory of one SM (228 KB); each resident block also holds 1 KB for
# the runtime.  A block of the persistent kernels (every kernel of csrc/)
# that leaves room for a second one takes at most SM_SMEM_BYTES / 2 - 1 KB.
SM_SMEM_BYTES = 233472
TWO_BLOCK_SMEM_BYTES = SM_SMEM_BYTES // 2 - 1024  # 115,712
ASYNC_THREADS = 256  # kron::kAsyncThreads: threads of a persistent kernel's block
_WARPS = ASYNC_THREADS // 32


def _r4(e: int) -> int:
    return -(-e // 4) * 4


def _r8(e: int) -> int:
    return -(-e // 8) * 8


def _r16(e: int) -> int:
    return -(-e // 16) * 16


def df_items(p: int, q: int) -> int:
    """Persistent dF items of one (p, q) factor in grad.cu: its 4x4 register
    tiles times the groups that split the contraction (``kron::df_tiles *
    kron::df_groups``), each item 16 sums in its owner's slice."""
    tiles = -(-p // 4) * -(-q // 4)
    return tiles * (1 if tiles >= ASYNC_THREADS else ASYNC_THREADS // tiles)


_MMA_ITEMS = 8  # kMmaItems in csrc/grad.cu: dF output tiles per warp in registers


def _mma_tiles(p: int, q: int) -> int:
    """16 x 8 output tiles of a (p, q) dF on the tensor cores."""
    return (-(-p // 16)) * (_r8(q) // 8)


def grad_uses_mma(ps: Sequence[int], qs: Sequence[int], in_bytes: int) -> bool:
    """grad.cu runs a stage on the tensor cores (grad_mma_kernel) when it is
    one bf16 factor whose dF tiles fit the warps' registers."""
    return len(ps) == 1 and in_bytes == 2 and _mma_tiles(ps[0], qs[0]) <= _MMA_ITEMS * _WARPS


def _grad_smem_bytes(t_m, t_k, ps, qs, acc_bytes, in_bytes) -> int:
    """grad.cu's shared memory (``grad_args``), in bytes, every region
    rounded to 16 bytes: the slot of the raw x slab (and raw dY block) in
    the input dtype, then either (``grad_uses_mma``) the tensor-core
    operands x^T, dY^T and F, at least as large as the warps' dF sums
    when several warps share an output tile, or the forward states, the
    gradient state G_n (where f32 and f64 multi-factor stages copy dY
    directly), the two gradient states G_{n-1} .. G_1 in turn, the panels
    of both orientations and the persistent dF items."""
    n = len(ps)
    s, cols = [], t_k
    for p, q in zip(ps, qs):
        s.append(cols // p)
        cols = cols // p * q
    direct = in_bytes == acc_bytes and n > 1
    slot = _r16(t_m * t_k * in_bytes) + (0 if direct else _r16(t_m * cols * in_bytes))
    if grad_uses_mma(ps, qs, in_bytes):
        p, q = ps[0], qs[0]
        k16 = -(-t_m * s[0] // 16) * 16
        q16 = -(-q // 16) * 16
        ops = slot + sum(_r16(e) for e in (
            2 * (-(-p // 16) * 16) * (k16 + 8), 2 * q16 * (k16 + 8), 2 * _r8(p) * (q16 + 8),
        ))
        ct = _mma_tiles(p, q)
        groups = 1 if ct >= _WARPS else _WARPS // ct
        return max(ops, 512 * ct * groups if groups > 1 else 0)
    u = sum(_r16(t_m * p * (si | 1) * acc_bytes) for p, si in zip(ps, s))
    gn = _r16(t_m * qs[-1] * (s[-1] | 1) * acc_bytes)
    g = [0, 0]
    for i in range(n - 1):  # G_{i+1}, i = n-2 .. 0
        k = (n - 2 - i) % 2
        g[k] = max(g[k], _r16(t_m * qs[i] * (s[i] | 1) * acc_bytes))
    fpan = sum(_r16(p * _r4(q) * acc_bytes) for p, q in zip(ps[:-1], qs[:-1]))
    tpan = sum(_r16(q * _r4(p) * acc_bytes) for p, q in zip(ps, qs))
    dfp = sum(_r16(16 * df_items(p, q) * acc_bytes) for p, q in zip(ps, qs))
    return slot + u + gn + g[0] + g[1] + fpan + tpan + dfp


def _chain_smem_bytes(kind, t_m, t_k, ps, t_qs, acc_bytes, in_bytes, q_tiled) -> int:
    """chain_fwd.cu's / chain_bwd.cu's shared memory (``kron::chain_args``),
    in bytes, every region rounded to 16 bytes."""
    n = len(ps)
    s, c = [], [t_k]
    for p, tq in zip(ps, t_qs):
        s.append(c[-1] // p)
        c.append(s[-1] * tq)
    size = [0, 0]
    if kind == "chain_fwd":
        slots = _r16(t_m * t_k * in_bytes)
        for i, p in enumerate(ps):  # state i: (t_m, p_i, s_i | 1)
            size[i % 2] = max(size[i % 2], _r16(t_m * p * (s[i] | 1) * acc_bytes))
        panels = sum(_r16(p * _r8(tq) * acc_bytes) for p, tq in zip(ps, t_qs))
        table, acc = _r16(4 * s[-1]), 0
    else:
        slots = 2 * _r16(t_m * c[n] * in_bytes)
        for j in range(n - 1):  # step j writes the flat G_{n-1-j}
            size[j % 2] = max(size[j % 2], _r16(t_m * c[n - 1 - j] * acc_bytes))
        panels = sum(_r16(tq * _r8(p) * acc_bytes) for p, tq in zip(ps, t_qs))
        table = _r16(4 * (c[n] // (t_k // math.prod(ps))))
        acc = _r16(t_m * t_k * acc_bytes) if q_tiled else 0
    return slots + size[0] + size[1] + panels + table + acc


def block_smem_bytes(
    t_m: int,
    t_k: int,
    ps: Sequence[int],
    t_qs: Sequence[int],
    acc_bytes: int,
    *,
    kind: str,
    q_tiled: bool = False,
    in_bytes: int | None = None,
) -> int:
    """Shared memory of one block of a chain kernel, in bytes; ``in_bytes``
    is the input dtype's size (default ``acc_bytes``).  Every region is
    rounded to 16 bytes.

    ``kind="chain_fwd"`` (chain_fwd.cu): the slot of the raw ``(t_m, t_k)``
    x slab in the input dtype; the two buffers of the chain states ``0 ..
    n-1`` in turn, each ``(t_m, p_i, s_i | 1)`` in the accumulator type;
    every factor's ``(p_i, t_q_i)`` panel, columns padded to 8; the
    final-index table, one int per slice of the last state.

    ``kind="chain_bwd"`` (chain_bwd.cu): two slots of the flat dY block
    ``(t_m, c_n)`` in the input dtype (``c_0 = t_k``, ``c_{i+1} = t_q_i *
    c_i / p_i``); the two buffers of the flat states ``c_{n-1} .. c_1`` in
    turn; every factor's transposed ``(t_q_i, p_i)`` panel, rows padded to
    8; the dY run table, one int per run of ``t_k / prod(ps)`` elements;
    and, when Q is tiled (``q_tiled``), the ``(t_m, t_k)`` sum of dX.

    ``kind="grad"`` (grad.cu; ``t_qs`` must be the whole Q): see
    ``_grad_smem_bytes``.  The sliced kernels have their own models
    (``kron_sliced.sliced_smem_bytes``, ``sliced_t_smem_bytes``)."""
    if kind not in _KINDS_SMEM:
        raise ValueError(f"unknown kernel kind {kind!r}")
    ib = acc_bytes if in_bytes is None else in_bytes
    if kind == "grad":
        return _grad_smem_bytes(t_m, t_k, tuple(ps), tuple(t_qs), acc_bytes, ib)
    return _chain_smem_bytes(kind, t_m, t_k, tuple(ps), tuple(t_qs), acc_bytes, ib, q_tiled)


def block_tile(
    t_m: int,
    t_k: int,
    ps: Sequence[int],
    t_qs: Sequence[int],
    acc_bytes: int,
    *,
    kind: str,
    q_tiled: bool = False,
    in_bytes: int | None = None,
) -> tuple[int, int]:
    """The block tile ``(t_m', t_k')`` of a chain kernel of the given kind
    (``block_smem_bytes``): ``t_m'`` divides ``t_m``, ``t_k'`` is a multiple
    of ``prod(ps)`` dividing ``t_k`` (tiles never split a contraction, so the
    choice changes no result).  This rule owns the kernels' block tiles; the
    plan's ``(t_m, t_k)`` only bounds them.  The tiles that leave room for a
    second block on the SM (``TWO_BLOCK_SMEM_BYTES``) come first, then those
    whose runs of the ``(M, Q_{n-1}..Q_0, S)`` view fill a 32-byte sector
    (``t_k' / prod(ps) * in_bytes >= 32``), then the largest ``t_m' * t_k'``,
    ties to the wider slab; a tile that fits only one block is taken when
    nothing smaller fits.  Whether two blocks are resident also depends on
    registers: the launch takes the blocks per SM from the occupancy query,
    not from this rule.  Raises ``VmemOverflowError`` when not even
    ``t_m'=1, t_k'=prod(ps)`` fits one block."""
    pprod = math.prod(ps)
    ib = acc_bytes if in_bytes is None else in_bytes
    fits = []
    for d in _divisors(t_k // pprod):
        tk = d * pprod
        for tm in _divisors(t_m):
            nbytes = block_smem_bytes(
                tm, tk, ps, t_qs, acc_bytes, kind=kind, q_tiled=q_tiled, in_bytes=ib
            )
            if nbytes <= SMEM_BYTES:
                fits.append((nbytes <= TWO_BLOCK_SMEM_BYTES, d * ib >= 32, tm * tk, tk, tm))
    if not fits:
        need = block_smem_bytes(
            1, pprod, ps, t_qs, acc_bytes, kind=kind, q_tiled=q_tiled, in_bytes=ib
        )
        raise VmemOverflowError(
            f"{kind} chain {list(ps)} with Q-tiles {list(t_qs)} needs {need} bytes "
            f"of shared memory at the smallest block tile (t_m'=1, t_k'={pprod}); "
            f"one block holds {SMEM_BYTES}: tile Q via t_qs or split the stage"
        )
    best = max(fits)
    return best[4], best[3]


def chain_geometry(
    x_shape: Sequence[int],
    f_shapes: Sequence[Sequence[int]],
    *,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    acc_bytes: int = 4,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
    direction: str = "fwd",
    in_bytes: int | None = None,
) -> ChainGeometry:
    """Check a chain's tiles as ``chain_pallas`` does, then pick the
    kernel's block tile for inputs of ``in_bytes`` (default ``acc_bytes``).
    ``direction="fwd"``: ``x_shape`` is x's ``(B, M, K)``; ``"bwd"``: it is
    dY's ``(B, M, prod(Q) * S)`` and ``k`` is dX's column count.  Raises
    ``LoweringError`` on shapes or tiles the kernel cannot take and
    ``VmemOverflowError`` when the planned tile exceeds the budget
    (``fused_growth`` forward, ``transposed_growth`` backward) or no block
    tile fits shared memory.  Memoized: a call's geometry depends on shapes
    and tiles only, and working it out costs more host time than a small
    launch."""
    if direction not in ("fwd", "bwd"):
        raise LoweringError(f"unknown direction {direction!r}")
    return _chain_geometry(
        tuple(int(d) for d in x_shape),
        tuple(tuple(int(d) for d in f) for f in f_shapes),
        t_b, t_m, t_k, None if t_qs is None else tuple(t_qs), acc_bytes,
        vmem_budget_elems, direction, acc_bytes if in_bytes is None else in_bytes,
    )


@functools.lru_cache(maxsize=1024)
def _chain_geometry(
    x_shape: tuple[int, ...],
    f_shapes: tuple[tuple[int, ...], ...],
    t_b: int,
    t_m: int,
    t_k: int | None,
    t_qs: tuple[int, ...] | None,
    acc_bytes: int,
    vmem_budget_elems: int,
    direction: str,
    in_bytes: int,
) -> ChainGeometry:
    b, m, cols = x_shape
    n = len(f_shapes)
    ps = tuple(f[1] for f in f_shapes)
    qs = tuple(f[2] for f in f_shapes)
    for f in f_shapes:
        if int(f[0]) != b:
            raise LoweringError(f"factor batch {f[0]} != x batch {b}")
    pprod = math.prod(ps)
    qprod = math.prod(qs)
    if direction == "fwd":
        if cols % pprod:
            raise LoweringError(f"K={cols} not divisible by prod(P)={pprod}")
        k = cols
    else:
        if cols % qprod:
            raise LoweringError(f"dY cols {cols} not divisible by prod(Q)={qprod}")
        k = cols // qprod * pprod
    t_b = min(t_b, b)
    t_m = min(t_m, m)
    t_k = min(t_k or k, k)
    if t_qs is None:
        t_qs = qs
    t_qs = tuple(min(t, q) for t, q in zip(t_qs, qs))
    if len(t_qs) != n:
        raise LoweringError(f"t_qs needs one entry per factor: {t_qs} vs {n}")
    if any(q % t for q, t in zip(qs, t_qs)):
        raise LoweringError(f"t_qs must divide factor Q dims: {t_qs} vs {qs}")
    if t_k % pprod:
        raise LoweringError(f"T_K={t_k} must be a multiple of prod(P)={pprod}")
    growth_fn = fused_growth if direction == "fwd" else transposed_growth
    growth = growth_fn(ps, qs, t_qs)
    if t_b * t_m * t_k * growth > vmem_budget_elems:
        raise VmemOverflowError(
            f"tile {t_b}x{t_m}x{t_k} (growth {growth:.2f}) exceeds the "
            f"per-block budget; reduce t_b / t_m / t_k or tile Q via t_qs"
        )
    if b % t_b or m % t_m or k % t_k:
        raise LoweringError(
            f"tiles must divide dims: {(b, m, k)} vs {(t_b, t_m, t_k)}"
        )
    if n > _MAX_FACTORS:
        raise LoweringError(f"a stage chains at most {_MAX_FACTORS} factors, got {n}")
    block_m, block_k = block_tile(
        t_m, t_k, ps, t_qs, acc_bytes, kind=f"chain_{direction}",
        q_tiled=direction == "bwd" and t_qs != qs, in_bytes=in_bytes,
    )
    return ChainGeometry(b, m, k, ps, qs, t_qs, block_m, block_k, direction)


@dataclasses.dataclass(frozen=True)
class GradGeometry:
    """A stage backward's checked dims and the kernel's block tile."""

    b: int
    m: int
    k: int
    ps: tuple[int, ...]
    qs: tuple[int, ...]
    block_m: int
    block_k: int


def grad_geometry(
    x_shape: Sequence[int],
    dy_shape: Sequence[int],
    f_shapes: Sequence[Sequence[int]],
    *,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    acc_bytes: int = 4,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
    in_bytes: int | None = None,
) -> GradGeometry:
    """Check a stage backward's tiles as ``grad_pallas`` does (the live set
    sums every chain state plus the gradient tile), then pick the kernel's
    block tile for inputs of ``in_bytes`` (default ``acc_bytes``).  Raises
    ``LoweringError`` on shapes or tiles the kernel cannot take and
    ``VmemOverflowError`` when the live set exceeds the budget or no block
    tile fits shared memory.  Memoized."""
    return _grad_geometry(
        tuple(int(d) for d in x_shape),
        tuple(int(d) for d in dy_shape),
        tuple(tuple(int(d) for d in f) for f in f_shapes),
        t_b, t_m, t_k, acc_bytes, vmem_budget_elems,
        acc_bytes if in_bytes is None else in_bytes,
    )


def grad_live_elems(t_k: int, ps: Sequence[int], qs: Sequence[int]) -> float:
    """Live set of one row of a stage backward's tile (``grad_pallas``):
    every chain state from ``t_k`` columns on, plus the gradient tile at the
    stage's output width — a sum over chain states, not a max."""
    cols = float(t_k)
    live = cols
    for p, q in zip(ps, qs):
        cols = cols / p * q
        live += cols
    return live + cols


@functools.lru_cache(maxsize=1024)
def _grad_geometry(
    x_shape: tuple[int, ...],
    dy_shape: tuple[int, ...],
    f_shapes: tuple[tuple[int, ...], ...],
    t_b: int,
    t_m: int,
    t_k: int | None,
    acc_bytes: int,
    vmem_budget_elems: int,
    in_bytes: int,
) -> GradGeometry:
    b, m, k = x_shape
    ps = tuple(f[1] for f in f_shapes)
    qs = tuple(f[2] for f in f_shapes)
    for f in f_shapes:
        if int(f[0]) != b:
            raise LoweringError(f"factor batch {f[0]} != x batch {b}")
    pprod = math.prod(ps)
    if k % pprod:
        raise LoweringError(f"K={k} not divisible by prod(P)={pprod}")
    want = (b, m, math.prod(qs) * (k // pprod))
    if dy_shape != want:
        raise LoweringError(f"dy shape {dy_shape} != {want}")
    t_b = min(t_b, b)
    t_m = min(t_m, m)
    t_k = min(t_k or k, k)
    if t_k % pprod:
        raise LoweringError(f"T_K={t_k} must be a multiple of prod(P)={pprod}")
    live = t_b * t_m * grad_live_elems(t_k, ps, qs)
    if live > vmem_budget_elems:
        raise VmemOverflowError(
            f"bwd tile {t_b}x{t_m}x{t_k} live set {int(live)} elems exceeds the "
            f"per-block budget; reduce t_b / t_k or split the stage"
        )
    if b % t_b or m % t_m or k % t_k:
        raise LoweringError(
            f"tiles must divide dims: {(b, m, k)} vs {(t_b, t_m, t_k)}"
        )
    if len(ps) > _MAX_FACTORS:
        raise LoweringError(f"a stage chains at most {_MAX_FACTORS} factors, got {len(ps)}")
    block_m, block_k = block_tile(t_m, t_k, ps, qs, acc_bytes, kind="grad", in_bytes=in_bytes)
    return GradGeometry(b, m, k, ps, qs, block_m, block_k)


def kernel_dtype_code(
    x: torch.Tensor, factors: Sequence[torch.Tensor], acc: torch.dtype
) -> int:
    """The kernels' dtype code for (x's dtype, acc); factors must match x."""
    for f in factors:
        if f.dtype != x.dtype:
            raise LoweringError(f"factor dtype {f.dtype} != x dtype {x.dtype}")
    code = _KERNEL_DTYPES.get((x.dtype, acc))
    if code is None:
        raise LoweringError(
            f"the CUDA kernels take float32, bfloat16 (acc float32) and "
            f"float64 (acc float64); got {x.dtype} with acc {acc}"
        )
    return code


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def kernel_fn(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """``kron_<name>`` of ``csrc/<name>.cu`` (built on first use), with its
    ctypes signature set once; every pointer and the stream are
    ``c_void_p`` so no 64-bit value is cut."""
    fn = getattr(_build.library(name), f"kron_{name}")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise ``RuntimeError`` for a kernel's nonzero launch status."""
    if err:
        raise RuntimeError(
            f"{name} launch failed: {_build.error_string(_build.library(name), err)}"
        )


_LL, _I, _VP = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_IP, _VPP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
# kron_chain_fwd / kron_chain_bwd(dtype, in, out, fs, ps, qs, tqs, n, B, M,
# K, t_m, t_k, nblk, stream).
_CHAIN_ARGS = (_I, _VP, _VP, _VPP, _IP, _IP, _IP, _I, _LL, _LL, _LL, _I, _I, _I, _VP)
# kron_grad(dtype, x, dy, dx, part, df, fs, ps, qs, n, B, M, K, t_m, t_k,
# nblk, stream).
_GRAD_ARGS = (_I, _VP, _VP, _VP, _VP, _VP, _VPP, _IP, _IP, _I, _LL, _LL, _LL, _I, _I, _I, _VP)
# kron_grad_occupancy(dtype, x, dy, ps, qs, n, M, K, t_m, t_k, &blocks, &smem).
_GRAD_OCC_ARGS = (_I, _VP, _VP, _IP, _IP, _I, _LL, _LL, _I, _I)


def chain_flops(b: int, m: int, k: int, ps: Sequence[int], qs: Sequence[int]) -> int:
    """Multiply-adds x 2 of a chain of factors ``(p_i, q_i)`` (application
    order) over ``b`` samples of ``m`` rows of ``k`` input columns; its
    transpose does as many."""
    cols, flops = k, 0
    for p, q in zip(ps, qs):
        flops += 2 * m * cols * q
        cols = cols // p * q
    return b * flops


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _chain_launch(inp, out, factors, geo, code):
    """One launch of the chain kernel of ``geo.direction`` on a persistent
    grid: as many blocks as the card holds at once (``grad_blocks`` from the
    occupancy query), never more than the walk has tiles."""
    name = f"chain_{geo.direction}"
    per_sm, _ = chain_occupancy(geo, code, inp.device)
    nblk = grad_blocks(sm_count(inp.device), per_sm, geo.tiles, 1)
    with torch.cuda.device(inp.device):
        err = kernel_fn(name, _CHAIN_ARGS)(
            code, inp.data_ptr(), out.data_ptr(), _ptrs(factors), _ints(geo.ps),
            _ints(geo.qs), _ints(geo.t_qs), len(factors), geo.b, geo.m, geo.k,
            geo.block_m, geo.block_k, nblk, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(name, err)


def chain_cuda(
    x: torch.Tensor,
    *factors: torch.Tensor,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    acc_dtype: str | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """One launch of the forward chain kernel (``csrc/chain_fwd.cu``).

    ``x: (B, M, K)``; each factor ``(B, P_i, Q_i)`` in application order
    (B=1 for an unbatched stage).  Returns the ``(B, M, prod(Q) * K/prod(P))``
    chain output in x's dtype, accumulated in ``acc_dtype`` through the whole
    chain.  The tiles are checked as ``chain_pallas`` checks them; the block
    tile is ``block_tile``'s, the persistent grid from the occupancy query.
    Raises on CPU tensors: their path is ``chain_reference``.
    """
    global chain_launches
    acc = _resolve_acc(acc_dtype, x.dtype)
    geo = chain_geometry(
        x.shape, [f.shape for f in factors], t_b=t_b, t_m=t_m, t_k=t_k,
        t_qs=t_qs, acc_bytes=acc.itemsize, vmem_budget_elems=vmem_budget_elems,
        in_bytes=x.element_size(),
    )
    require_cuda("chain_cuda", x, *factors)
    code = kernel_dtype_code(x, factors, acc)
    y = torch.empty((geo.b, geo.m, geo.out_cols), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if hlo_cost.ACTIVE:
        hlo_cost.count_kernel("chain_fwd", chain_flops(geo.b, geo.m, geo.k, geo.ps, geo.qs),
                              _nbytes(x, y, *factors))
    if isinstance(x, FakeTensor):  # a dry-run's trace: counted, never launched
        return y
    _chain_launch(x, y, factors, geo, code)
    chain_launches += 1
    return y


def chain_reference(
    x: torch.Tensor, *factors: torch.Tensor, acc_dtype: str | None = None
) -> torch.Tensor:
    """The chain kernel's plain PyTorch twin: the same function as
    ``chain_cuda``.  The intermediates stay in the accumulator dtype through
    the chain and round to x's dtype once at the end, as the kernel (and the
    Pallas ``_chain_kernel``) does."""
    acc = _resolve_acc(acc_dtype, x.dtype)
    y = x.to(acc)
    for f in factors:
        y = sliced_apply(y, f, acc)
    return y.to(x.dtype)


def chain_bwd_cuda(
    dy: torch.Tensor,
    *factors: torch.Tensor,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    acc_dtype: str | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """One launch of the transposed chain kernel (``csrc/chain_bwd.cu``).

    ``dy: (B, M, prod(Q) * S)``; each factor ``(B, P_i, Q_i)`` in
    application order.  Returns dX ``(B, M, prod(P) * S)`` in dy's dtype:
    the transposes applied last-applied factor first, the partial dX of the
    Q-tiles (``t_qs``) summed in ``acc_dtype`` inside the kernel.  ``t_k`` is
    in dX's columns.  The tiles are checked as ``chain_pallas(direction=
    "bwd")`` checks them; the block tile is ``block_tile``'s, the persistent
    grid from the occupancy query.  Raises on CPU tensors: their path is
    ``chain_bwd_reference``.
    """
    global chain_bwd_launches
    acc = _resolve_acc(acc_dtype, dy.dtype)
    geo = chain_geometry(
        dy.shape, [f.shape for f in factors], t_b=t_b, t_m=t_m, t_k=t_k,
        t_qs=t_qs, acc_bytes=acc.itemsize, vmem_budget_elems=vmem_budget_elems,
        direction="bwd", in_bytes=dy.element_size(),
    )
    require_cuda("chain_bwd_cuda", dy, *factors)
    code = kernel_dtype_code(dy, factors, acc)
    dx = torch.empty((geo.b, geo.m, geo.k), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    if hlo_cost.ACTIVE:
        hlo_cost.count_kernel("chain_bwd", chain_flops(geo.b, geo.m, geo.k, geo.ps, geo.qs),
                              _nbytes(dy, dx, *factors))
    if isinstance(dy, FakeTensor):  # a dry-run's trace: counted, never launched
        return dx
    _chain_launch(dy, dx, factors, geo, code)
    chain_bwd_launches += 1
    return dx


def chain_bwd_reference(
    dy: torch.Tensor, *factors: torch.Tensor, acc_dtype: str | None = None
) -> torch.Tensor:
    """The transposed chain kernel's plain PyTorch twin: the transposes,
    last-applied factor first, in the accumulator dtype, rounded to dy's
    dtype once at the end."""
    acc = _resolve_acc(acc_dtype, dy.dtype)
    g = dy.to(acc)
    for f in reversed(factors):
        g = sliced_apply_t(g, f, acc)
    return g.to(dy.dtype)


def grad_blocks(sms: int, per_sm: int, tiles: int, b: int) -> int:
    """Blocks per batch sample of a persistent launch (grad.cu; the chain
    kernels and sliced_t.cu with ``b=1``): as many as the card holds at once
    (``sms`` SMs times the ``per_sm`` blocks the occupancy query reports),
    shared among the ``b`` samples, never more than a sample has tiles and
    at least one.  Each block of the stage backward writes one dF partial."""
    return max(1, min(tiles, sms * per_sm // b))


def occupancy(name: str, argtypes: Sequence, *args) -> tuple[int, int]:
    """``kron_<name>_occupancy(*args, &blocks, &smem)`` of ``csrc/<name>.cu``:
    (blocks of the kernel per SM at the launch's threads and shared memory,
    that shared memory in bytes).  Raises when the kernel cannot launch."""
    fn = getattr(_build.library(name), f"kron_{name}_occupancy")
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    check_launch(name, fn(*args, ctypes.byref(blocks), ctypes.byref(smem)))
    if blocks.value < 1:
        raise RuntimeError(f"{name}: no block fits an SM at {smem.value} bytes of shared memory")
    return blocks.value, smem.value


# dtype code -> (input, accumulator) bytes
CODE_BYTES = {code: (i.itemsize, a.itemsize) for (i, a), code in _KERNEL_DTYPES.items()}


@functools.lru_cache(maxsize=256)
def _grad_occupancy(code, x_align, dy_align, ps, qs, m, k, t_m, t_k, device):
    with torch.cuda.device(device):
        per_sm, smem = occupancy(
            "grad", _GRAD_OCC_ARGS, code, x_align, dy_align, _ints(ps), _ints(qs),
            len(ps), m, k, t_m, t_k,
        )
    in_bytes, acc_bytes = CODE_BYTES[code]
    model = block_smem_bytes(t_m, t_k, ps, qs, acc_bytes, kind="grad", in_bytes=in_bytes)
    if smem != model:
        raise RuntimeError(f"grad.cu lays out {smem} bytes of shared memory, the model {model}")
    return per_sm, smem


def grad_occupancy(x: torch.Tensor, dy: torch.Tensor, geo: GradGeometry, code: int) -> tuple[int, int]:
    """(blocks per SM, shared-memory bytes) of the stage backward at ``geo``'s
    block tile, from the kernel's occupancy query; memoized.  The pointers'
    residues mod 16 set the ring's copy width, so they are part of the key.
    Raises when the kernel's layout and ``block_smem_bytes`` disagree."""
    return _grad_occupancy(
        code, x.data_ptr() % 16, dy.data_ptr() % 16, geo.ps, geo.qs, geo.m, geo.k,
        geo.block_m, geo.block_k, x.device,
    )


# kron_chain_fwd_occupancy / kron_chain_bwd_occupancy(dtype, ps, qs, tqs, n,
# M, K, t_m, t_k, &blocks, &smem).
_CHAIN_OCC_ARGS = (_I, _IP, _IP, _IP, _I, _LL, _LL, _I, _I)


@functools.lru_cache(maxsize=256)
def _chain_occupancy(direction, code, ps, qs, t_qs, m, k, t_m, t_k, device):
    name = f"chain_{direction}"
    with torch.cuda.device(device):
        per_sm, smem = occupancy(
            name, _CHAIN_OCC_ARGS, code, _ints(ps), _ints(qs), _ints(t_qs), len(ps), m, k,
            t_m, t_k,
        )
    in_bytes, acc_bytes = CODE_BYTES[code]
    model = block_smem_bytes(
        t_m, t_k, ps, t_qs, acc_bytes, kind=name, q_tiled=t_qs != qs, in_bytes=in_bytes,
    )
    if smem != model:
        raise RuntimeError(f"{name}.cu lays out {smem} bytes of shared memory, the model {model}")
    return per_sm, smem


def chain_occupancy(geo: ChainGeometry, code: int, device: torch.device) -> tuple[int, int]:
    """(blocks per SM, shared-memory bytes) of the chain kernel of
    ``geo.direction`` at ``geo``'s block tile, from the kernel's occupancy
    query (``kron_chain_fwd_occupancy`` / ``kron_chain_bwd_occupancy``);
    memoized.  Raises when the kernel's layout and ``block_smem_bytes``
    disagree."""
    return _chain_occupancy(
        geo.direction, code, geo.ps, geo.qs, geo.t_qs, geo.m, geo.k, geo.block_m,
        geo.block_k, device,
    )


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grad_cuda(
    x: torch.Tensor,
    dy: torch.Tensor,
    *factors: torch.Tensor,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    acc_dtype: str | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The stage backward kernel (``csrc/grad.cu``): (dx, factor grads).

    ``x: (B, M, K)`` stage input, ``dy: (B, M, prod(Q) * S)`` stage output
    cotangent, factors ``(B, P_i, Q_i)`` in application order.  Returns dx
    in x's dtype and one ``(B, P_i, Q_i)`` grad per factor, in application
    order, in the accumulator dtype.  Two launches: the stage backward on a
    persistent grid (``grad_blocks`` from the occupancy query), whose blocks
    each write one dF partial, and the reduction of the partials in block
    order.  The tiles are checked as ``grad_pallas`` checks them.  Raises on
    CPU tensors: their path is ``grad_reference``.
    """
    acc = _resolve_acc(acc_dtype, dy.dtype)
    geo = grad_geometry(
        x.shape, dy.shape, [f.shape for f in factors], t_b=t_b, t_m=t_m,
        t_k=t_k, acc_bytes=acc.itemsize, vmem_budget_elems=vmem_budget_elems,
        in_bytes=x.element_size(),
    )
    require_cuda("grad_cuda", x, dy, *factors)
    code = kernel_dtype_code(x, (dy, *factors), acc)
    sizes = [p * q for p, q in zip(geo.ps, geo.qs)]
    total = sum(sizes)
    dx = torch.empty((geo.b, geo.m, geo.k), dtype=x.dtype, device=x.device)
    if not dx.numel():
        df = torch.zeros((geo.b, total), dtype=acc, device=x.device)
    else:
        df = torch.empty((geo.b, total), dtype=acc, device=x.device)
        if hlo_cost.ACTIVE:  # dF and dx, and the chain re-run up to the last factor
            flops = (2 * chain_flops(geo.b, geo.m, geo.k, geo.ps, geo.qs)
                     + chain_flops(geo.b, geo.m, geo.k, geo.ps[:-1], geo.qs[:-1]))
            hlo_cost.count_kernel("grad", flops, _nbytes(x, dy, dx, df, *factors))
        if not isinstance(x, FakeTensor):  # a dry-run's trace: counted, never launched
            _grad_launch(x, dy, dx, df, factors, geo, code)
    dfs = torch.split(df, sizes, dim=1)
    return dx, tuple(d.reshape(geo.b, p, q) for d, p, q in zip(dfs, geo.ps, geo.qs))


def _grad_launch(x, dy, dx, df, factors, geo: GradGeometry, code: int) -> None:
    """The stage backward's two launches on a persistent grid: each block
    writes one dF partial, then the partials are reduced into ``df``."""
    global grad_launches, grad_reduce_launches
    total = int(df.shape[1])
    per_sm, _ = grad_occupancy(x, dy, geo, code)
    tiles = (geo.m // geo.block_m) * (geo.k // geo.block_k)
    nblk = grad_blocks(sm_count(x.device), per_sm, tiles, geo.b)
    part = torch.empty((geo.b * nblk * total,), dtype=df.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = kernel_fn("grad", _GRAD_ARGS)(
            code, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
            df.data_ptr(), _ptrs(factors), _ints(geo.ps), _ints(geo.qs),
            len(factors), geo.b, geo.m, geo.k, geo.block_m, geo.block_k, nblk,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch("grad", err)
    grad_launches += 1
    grad_reduce_launches += 1


def grad_reference(
    x: torch.Tensor,
    dy: torch.Tensor,
    *factors: torch.Tensor,
    acc_dtype: str | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The stage backward kernel's plain PyTorch twin: the same (dx, factor
    grads) as ``grad_cuda``, 3-D operands.  The forward states and the
    gradient stay in the accumulator dtype through the stage; dx rounds to
    x's dtype once, the grads stay in the accumulator dtype."""
    acc = _resolve_acc(acc_dtype, dy.dtype)
    us = [x.to(acc)]
    for f in factors[:-1]:  # the inputs of the factors after the first
        us.append(sliced_apply(us[-1], f, acc))
    g = dy.to(acc)
    dfs = [None] * len(factors)
    for idx in reversed(range(len(factors))):
        f = factors[idx]
        dfs[idx] = sliced_vjp_factor(us[idx], g, int(f.shape[-2]), int(f.shape[-1]), acc)
        g = sliced_apply_t(g, f, acc)
    return g.to(x.dtype), tuple(dfs)


# ---------------------------------------------------------------------------
# Instruction / program interpreters (the executor's public surface)
# ---------------------------------------------------------------------------


def _effective(instr: StageInstr, fs: tuple[torch.Tensor, ...]):
    """(factors, t_qs) after resolving a prekron instruction into its
    explicit product (a chain of one).  A length-1 ``t_qs`` on a prekron
    instruction is the Q-tile of the COMBINED product and survives the
    substitution; per-original-factor tiles do not apply to the product."""
    if instr.kind == PREKRON:
        t_qs = instr.t_qs if instr.t_qs and len(instr.t_qs) == 1 else None
        return (prekron_product(fs),), t_qs
    return fs, instr.t_qs


def _as_batched(instr: StageInstr, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The operands with a leading batch axis: unbatched instructions
    (``t_b=None``) run as a batch of one."""
    return list(tensors) if instr.t_b is not None else [t[None] for t in tensors]


def _same_device(y: torch.Tensor, fs: Sequence[torch.Tensor]) -> None:
    for f in fs:
        if f.device != y.device:
            raise ValueError(f"x on {y.device} but a factor on {f.device}")


def run_stage(
    y: torch.Tensor,
    stage_factors: Sequence[torch.Tensor],
    instr: StageInstr,
    *,
    backend: str = "auto",
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """Execute one chain instruction on ``y``: a forward chain
    (``direction="fwd"``) or its transpose (``"bwd"``: ``y`` is the stage
    output's cotangent, the result the input's).

    ``stage_factors`` are the stage's factors in application order — 2-D
    when ``instr.t_b is None``, per-sample 3-D otherwise — on ``y``'s device.
    The ``cuda`` backend (CUDA tensors by default) launches the chain kernel
    of the direction once; the ``torch`` backend (CPU tensors by default)
    runs its plain twin after the same tile checks, so a plan that cannot
    run on the card fails on the CPU too.  Raises ``VmemOverflowError`` /
    ``LoweringError`` on tiles the kernel cannot take.
    """
    chaos.maybe_fail("stage_execute")
    # One truthiness check when telemetry is off: span() returns a shared
    # no-op that enters no profiler range.
    with telemetry.span("stage", kind=instr.kind, direction=instr.direction):
        fs, t_qs = _effective(instr, tuple(stage_factors))
        _same_device(y, fs)
        b = resolve_backend(backend, y)
        y3, *fs3 = _as_batched(instr, y, *fs)
        tiles = dict(
            t_b=instr.t_b or 1, t_m=instr.t_m, t_k=instr.t_k, t_qs=t_qs,
            vmem_budget_elems=vmem_budget_elems,
        )
        fwd = instr.direction == "fwd"
        if b == "cuda":
            chaos.maybe_fail("pallas_lowering")
            kernel = chain_cuda if fwd else chain_bwd_cuda
            out = kernel(
                y3.contiguous(), *(f.contiguous() for f in fs3),
                acc_dtype=instr.acc_dtype, **tiles,
            )
        else:
            acc = _resolve_acc(instr.acc_dtype, y.dtype)
            chain_geometry(
                y3.shape, [f.shape for f in fs3], acc_bytes=acc.itemsize,
                direction=instr.direction, in_bytes=y.element_size(), **tiles,
            )
            twin = chain_reference if fwd else chain_bwd_reference
            out = twin(y3, *fs3, acc_dtype=instr.acc_dtype)
        return out if instr.t_b is not None else out[0]


def run_stage_grad(
    u: torch.Tensor,
    g: torch.Tensor,
    stage_factors: Sequence[torch.Tensor],
    instr: StageInstr,
    *,
    backend: str = "auto",
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Full backward of one forward chain instruction: (dx, factor grads).

    ``u`` is the stage input, ``g`` the stage output cotangent; ``instr`` is
    the FORWARD instruction (its transpose is implied; its ``t_qs`` does not
    apply, the stage backward takes Q whole).  Factor grads are returned in
    application order, accumulated in the stage's acc dtype (callers cast).
    The ``cuda`` backend launches the stage backward kernel
    (``grad_cuda``); the ``torch`` backend runs ``grad_reference`` after the
    same checks.  dx passes ``guard.check_finite``.  Raises
    ``VmemOverflowError`` when the stage's live set cannot fit one block.
    """
    chaos.maybe_fail("stage_execute")
    with telemetry.span("stage_grad", kind=instr.kind):
        fs = tuple(stage_factors)
        _same_device(u, (g, *fs))
        b = resolve_backend(backend, u)
        u3, g3, *fs3 = _as_batched(instr, u, g, *fs)
        tiles = dict(
            t_b=instr.t_b or 1, t_m=instr.t_m, t_k=instr.t_k,
            vmem_budget_elems=vmem_budget_elems,
        )
        if b == "cuda":
            chaos.maybe_fail("pallas_lowering")
            dx, dfs = grad_cuda(
                u3.contiguous(), g3.contiguous(), *(f.contiguous() for f in fs3),
                acc_dtype=instr.acc_dtype, **tiles,
            )
        else:
            acc = _resolve_acc(instr.acc_dtype, g.dtype)
            grad_geometry(
                u3.shape, g3.shape, [f.shape for f in fs3], acc_bytes=acc.itemsize,
                in_bytes=u.element_size(), **tiles,
            )
            dx, dfs = grad_reference(u3, g3, *fs3, acc_dtype=instr.acc_dtype)
        if instr.t_b is None:
            dx, dfs = dx[0], tuple(d[0] for d in dfs)
        return guard.check_finite(dx, "run_stage_grad"), dfs


def run_program(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    prog: StageProgram,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Interpret a StageProgram: walk its instructions over ``x``.

    ``factors`` is the full chain's factor tuple in PROBLEM order; each
    instruction selects its stage's factors via ``factor_ids`` into the
    reversed (application-order) list.  For a transposed program
    (``transpose(prog)``), ``x`` is the output cotangent and the result is
    the input cotangent.
    """
    factors = tuple(factors)
    if len(factors) != prog.n_factors:
        raise ValueError(
            f"program expects {prog.n_factors} factors, got {len(factors)}"
        )
    rev = tuple(reversed(factors))
    with telemetry.span("program", stages=len(prog.instrs)):
        y = x
        for instr in prog.instrs:
            y = run_stage(
                y, tuple(rev[i] for i in instr.factor_ids), instr, backend=backend
            )
    # Non-finite guard on the program's output: the value downstream layers
    # consume, after every stage's acc_dtype downcast.
    return guard.check_finite(y, "run_program")


def emit(prog: StageProgram, *, backend: str = "auto"):
    """Close a StageProgram over a backend: returns ``fn(x, factors)``.

    ``emit(transpose(prog))`` is the x-cotangent of ``emit(prog)``."""

    def fn(x, factors):
        return run_program(x, factors, prog, backend=backend)

    return fn


__all__ = [
    "StageInstr",
    "StageProgram",
    "ChainGeometry",
    "GradGeometry",
    "transpose",
    "emit",
    "run_program",
    "run_stage",
    "run_stage_grad",
    "sliced_apply",
    "sliced_apply_t",
    "sliced_vjp_factor",
    "prekron_product",
    "effective_slabs",
    "split_slabs",
    "chain_cuda",
    "chain_reference",
    "chain_bwd_cuda",
    "chain_bwd_reference",
    "grad_cuda",
    "grad_reference",
    "chain_geometry",
    "chain_walk",
    "chain_tile_coords",
    "grad_geometry",
    "grad_live_elems",
    "grad_blocks",
    "grad_occupancy",
    "chain_occupancy",
    "block_tile",
    "block_smem_bytes",
    "fused_growth",
    "transposed_growth",
    "max_n_fused",
    "acc_dtype_for",
    "resolve_backend",
    "MULTIPLY",
    "TRANSPOSED_MULTIPLY",
    "PREKRON",
    "SMEM_BYTES",
    "SMEM_BUDGET_ELEMS",
    "SM_SMEM_BYTES",
    "TWO_BLOCK_SMEM_BYTES",
]
