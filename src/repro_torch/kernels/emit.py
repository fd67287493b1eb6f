"""StageProgram IR and the executor behind every planned Kron-Matmul path.

The port of ``repro.kernels.emit`` for the forward pass:

* a ``StageInstr`` is one kernel launch, typed ``multiply`` /
  ``transposed_multiply`` / ``prekron`` and carrying everything the executor
  needs (``ps, qs, t_m, t_k, t_qs, t_b, direction, acc_dtype``).  ``t_b=None``
  means *unbatched*: batch is a leading axis of size one, not a separate code
  path.
* a ``StageProgram`` is a tuple of instructions; ``transpose(prog)`` derives
  the backward program mechanically.
* ``run_stage`` / ``run_program`` / ``emit`` execute forward instructions.  A
  stage on CUDA tensors is ONE launch of the hand-written chain kernel
  (``chain_cuda``, ``csrc/chain_fwd.cu``); on CPU tensors it runs the
  kernel's plain twin ``chain_reference``.  There is no fallback between the
  two: the tensors' device decides.

The backward instructions (``transposed_multiply`` and the stage backward)
are the next slice of the port (ROADMAP.md queue 2, items 2, 3 and 5);
executing one raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch

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

BACKWARD_SLICE = (
    "the backward pass (transposed chain, stage backward and transposed "
    "sliced multiply) is the next slice of the port: ROADMAP.md queue 2, "
    "items 2, 3 and 5"
)

# Launch counter of the chain kernel: +1 per launch, nowhere else.
chain_launches = 0

_MAX_FACTORS = 16  # kron::kMaxFactors in csrc/kron_tile.cuh
_KERNEL_DTYPES = {  # (input dtype, acc dtype) -> code in csrc/kron_tile.cuh
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """``"auto"`` picks by the tensor's device: ``"cuda"`` for a CUDA tensor,
    ``"torch"`` (the plain twins) for a CPU one.  An explicit backend must
    match the device: ``"cuda"`` on a CPU tensor and ``"torch"`` on a CUDA
    tensor raise ``ValueError``."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda":
        if not x.is_cuda:
            raise ValueError(f"backend='cuda' needs CUDA tensors, got {x.device}")
        return backend
    if backend == "torch":
        if x.is_cuda:
            raise ValueError(
                "backend='torch' runs the plain PyTorch twins, which take CPU "
                f"tensors; got {x.device}"
            )
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
    """A chain instruction's checked dims and the kernel's block tile."""

    b: int
    m: int
    k: int
    ps: tuple[int, ...]
    qs: tuple[int, ...]
    t_qs: tuple[int, ...]
    block_m: int  # t_m': rows per block, divides the instruction's t_m
    block_k: int  # t_k': input columns per block, divides t_k

    @property
    def out_cols(self) -> int:
        return math.prod(self.qs) * (self.k // math.prod(self.ps))


def block_smem_bytes(
    t_m: int, t_k: int, ps: Sequence[int], t_qs: Sequence[int], acc_bytes: int
) -> int:
    """Shared memory of one block of the chain kernel (kron::make_args): the
    two chain-state buffers (even and odd states, each (t_m, p_i, s_i | 1),
    rounded to 4 elements) and the largest (p_i, t_q_i) factor panel with
    its columns padded to a multiple of 4, in the accumulator type."""
    bufs = [0, 0]
    panel = 0
    cols = t_k
    for i, (p, tq) in enumerate(zip(ps, t_qs)):
        s = cols // p
        bufs[i % 2] = max(bufs[i % 2], -(-t_m * p * (s | 1) // 4) * 4)
        panel = max(panel, p * -(-tq // 4) * 4)
        cols = s * tq
    return acc_bytes * (bufs[0] + bufs[1] + panel)


def block_tile(
    t_m: int, t_k: int, ps: Sequence[int], t_qs: Sequence[int], acc_bytes: int
) -> tuple[int, int]:
    """The kernel's block tile ``(t_m', t_k')``: ``t_m'`` divides ``t_m``,
    ``t_k'`` is a multiple of ``prod(ps)`` dividing ``t_k`` (tiles never split
    a contraction, so the choice changes no result).  The largest
    ``t_m' * t_k'`` wins, ties to the wider slab, among the tiles that fit
    half of one block's shared memory, so that two blocks share an SM and
    one loads while the other computes; when none does, among those that
    fit at all.  Raises ``VmemOverflowError`` when not even
    ``t_m'=1, t_k'=prod(ps)`` fits."""
    pprod = math.prod(ps)
    fits = []
    for d in _divisors(t_k // pprod):
        tk = d * pprod
        for tm in _divisors(t_m):
            nbytes = block_smem_bytes(tm, tk, ps, t_qs, acc_bytes)
            if nbytes <= SMEM_BYTES:
                fits.append((nbytes <= SMEM_BYTES // 2, tm * tk, tk, tm))
    if not fits:
        need = block_smem_bytes(1, pprod, ps, t_qs, acc_bytes)
        raise VmemOverflowError(
            f"chain {list(ps)} with Q-tiles {list(t_qs)} needs {need} bytes of "
            f"shared memory at the smallest block tile (t_m'=1, t_k'={pprod}); "
            f"one block holds {SMEM_BYTES}: tile Q via t_qs or split the stage"
        )
    best = max(fits)
    return best[3], best[2]


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
) -> ChainGeometry:
    """Check a forward chain's tiles as ``chain_pallas`` does, then pick the
    kernel's block tile.  Raises ``LoweringError`` on shapes or tiles the
    kernel cannot take and ``VmemOverflowError`` when the planned tile
    exceeds the budget or no block tile fits shared memory.  Memoized: a
    call's geometry depends on shapes and tiles only, and working it out
    costs more host time than a small launch."""
    return _chain_geometry(
        tuple(int(d) for d in x_shape),
        tuple(tuple(int(d) for d in f) for f in f_shapes),
        t_b, t_m, t_k, None if t_qs is None else tuple(t_qs), acc_bytes,
        vmem_budget_elems,
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
) -> ChainGeometry:
    b, m, cols = x_shape
    n = len(f_shapes)
    ps = tuple(f[1] for f in f_shapes)
    qs = tuple(f[2] for f in f_shapes)
    for f in f_shapes:
        if int(f[0]) != b:
            raise LoweringError(f"factor batch {f[0]} != x batch {b}")
    pprod = math.prod(ps)
    if cols % pprod:
        raise LoweringError(f"K={cols} not divisible by prod(P)={pprod}")
    k = cols
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
    growth = fused_growth(ps, qs, t_qs)
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
    block_m, block_k = block_tile(t_m, t_k, ps, t_qs, acc_bytes)
    return ChainGeometry(b, m, k, ps, qs, t_qs, block_m, block_k)


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


def _chain_fn():
    fn = _build.library("chain_fwd").kron_chain_fwd
    if fn.argtypes is None:
        ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [
            i, vp, vp, ctypes.POINTER(vp), ip, ip, ip, i, ll, ll, ll, i, i, vp,
        ]
        fn.restype = ctypes.c_int
    return fn


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
    tile is ``block_tile``'s.  Raises on CPU tensors: their path is
    ``chain_reference``.
    """
    global chain_launches
    acc = _resolve_acc(acc_dtype, x.dtype)
    geo = chain_geometry(
        x.shape, [f.shape for f in factors], t_b=t_b, t_m=t_m, t_k=t_k,
        t_qs=t_qs, acc_bytes=acc.itemsize, vmem_budget_elems=vmem_budget_elems,
    )
    require_cuda("chain_cuda", x, *factors)
    code = kernel_dtype_code(x, factors, acc)
    y = torch.empty((geo.b, geo.m, geo.out_cols), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    n = len(factors)
    fn = _chain_fn()
    with torch.cuda.device(x.device):
        err = fn(
            code, x.data_ptr(), y.data_ptr(),
            (ctypes.c_void_p * n)(*(f.data_ptr() for f in factors)),
            (ctypes.c_int * n)(*geo.ps), (ctypes.c_int * n)(*geo.qs),
            (ctypes.c_int * n)(*geo.t_qs), n, geo.b, geo.m, geo.k,
            geo.block_m, geo.block_k, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"chain_fwd launch failed: {_build.error_string(_build.library('chain_fwd'), err)}"
        )
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


def run_stage(
    y: torch.Tensor,
    stage_factors: Sequence[torch.Tensor],
    instr: StageInstr,
    *,
    backend: str = "auto",
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """Execute one forward chain instruction on ``y``.

    ``stage_factors`` are the stage's factors in application order — 2-D
    when ``instr.t_b is None``, per-sample 3-D otherwise — on ``y``'s device.
    CUDA tensors launch the chain kernel once; CPU tensors run
    ``chain_reference`` after the same tile checks, so a plan that cannot
    run on the card fails on the CPU too.  Raises ``VmemOverflowError`` /
    ``LoweringError`` on tiles the kernel cannot take.
    """
    if instr.direction != "fwd":
        raise NotImplementedError(BACKWARD_SLICE)
    fs, t_qs = _effective(instr, tuple(stage_factors))
    for f in fs:
        if f.device != y.device:
            raise ValueError(f"x on {y.device} but a factor on {f.device}")
    b = resolve_backend(backend, y)
    batched = instr.t_b is not None
    y3 = y if batched else y[None]
    fs3 = fs if batched else tuple(f[None] for f in fs)
    tiles = dict(
        t_b=instr.t_b or 1, t_m=instr.t_m, t_k=instr.t_k, t_qs=t_qs,
        vmem_budget_elems=vmem_budget_elems,
    )
    if b == "cuda":
        out = chain_cuda(
            y3.contiguous(), *(f.contiguous() for f in fs3),
            acc_dtype=instr.acc_dtype, **tiles,
        )
    else:
        acc = _resolve_acc(instr.acc_dtype, y.dtype)
        chain_geometry(
            y3.shape, [f.shape for f in fs3], acc_bytes=acc.itemsize, **tiles
        )
        out = chain_reference(y3, *fs3, acc_dtype=instr.acc_dtype)
    return out if batched else out[0]


def run_program(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    prog: StageProgram,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Interpret a forward StageProgram: walk its instructions over ``x``.

    ``factors`` is the full chain's factor tuple in PROBLEM order; each
    instruction selects its stage's factors via ``factor_ids`` into the
    reversed (application-order) list.
    """
    factors = tuple(factors)
    if len(factors) != prog.n_factors:
        raise ValueError(
            f"program expects {prog.n_factors} factors, got {len(factors)}"
        )
    rev = tuple(reversed(factors))
    y = x
    for instr in prog.instrs:
        y = run_stage(
            y, tuple(rev[i] for i in instr.factor_ids), instr, backend=backend
        )
    return y


def emit(prog: StageProgram, *, backend: str = "auto"):
    """Close a forward StageProgram over a backend: returns ``fn(x, factors)``."""

    def fn(x, factors):
        return run_program(x, factors, prog, backend=backend)

    return fn


__all__ = [
    "StageInstr",
    "StageProgram",
    "ChainGeometry",
    "transpose",
    "emit",
    "run_program",
    "run_stage",
    "sliced_apply",
    "prekron_product",
    "chain_cuda",
    "chain_reference",
    "chain_geometry",
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
    "BACKWARD_SLICE",
]
