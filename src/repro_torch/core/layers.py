"""KronLinear: a projection stored as Kronecker factors (the paper's
ML-compression use, Table 4 rows 6-8).

The port of ``repro.core.layers`` for one device.  ``W = F^1 (x) ... (x)
F^N`` replaces a dense ``(d_in, d_out)`` matrix with ``sum_i P_i*Q_i``
parameters; the forward pass is one FastKron Kron-Matmul through a
``KronOp`` from the engine's bounded signature cache (``kron_op_for``), so
on CUDA tensors every apply runs the chain kernels and its backward the
stage-backward kernel (or the transposed chain when the factors are
frozen).

The functional surface takes the reference's parameter dict, ``{"factors":
(F^1, ..., F^N), "bias": b}`` (bias optional); ``KronLinear`` is an
``nn.Module`` holding the factors as an ``nn.ParameterList`` and the
resolved op.  Inside a ``kron_distributed(mesh)`` scope, ``(B, T, d)``
activations run the distributed Kron-Matmul on the scope's mesh.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from .engine import KronOp, kron_op_for, signature_of

# Active distributed-KronLinear scopes (innermost last), entered through
# ``kron_distributed``.
_DIST_SCOPES: list[tuple] = []


@contextlib.contextmanager
def kron_distributed(mesh, *, data_axis="data", model_axis="model"):
    """Route batched KronLinear applies through the distributed Kron-Matmul.

    Inside the scope, ``kron_linear_apply`` (and ``KronLinear.forward``) on
    a ``(B, T, d)`` activation that every rank holds in full runs the mesh
    ``KronOp`` on ``mesh`` (shared factors: ``B*T`` folds into the rows,
    sharded over ``data_axis``, the paper's round schedule): each rank
    keeps its slice of the activation (no communication), runs the rounds
    on it, and the result comes back replicated (an all-gather).  The
    factor gradients are summed over the mesh.  Shapes the mesh cannot host
    (rows not divisible by the data axis, ``K`` not by the model axis, or
    no legal relocation round) run local: the scope is an optimisation,
    never an error.  The routing is decided per call."""
    _DIST_SCOPES.append((mesh, data_axis, model_axis))
    try:
        yield
    finally:
        _DIST_SCOPES.pop()


def _mesh_op_maybe(ps, qs, b, m, backend) -> KronOp | None:
    """The innermost scope's mesh op when it can host a ``(b, m, K)``
    activation, else None."""
    if not _DIST_SCOPES:
        return None
    mesh, data_axis, model_axis = _DIST_SCOPES[-1]
    try:
        op = kron_op_for(
            ps, qs, batch=b, shared_factors=True, mesh=mesh, data_axis=data_axis,
            model_axis=model_axis, backend=backend,
        )
    except ValueError:
        # K not divisible by the model axis, or no legal relocation round
        # for this (K, G_K) (PlanError is a ValueError): run local.
        return None
    if (b * m) % op.g_m:
        return None
    return op


def _apply_batched_maybe_distributed(factors, x, backend, plan, op=None):
    """A ``(B, ..., d)`` apply: through the scope's mesh op when one hosts
    a 3-D ``x``, else the local batched op (or ``op``)."""
    ps, qs = signature_of(factors, shared_factors=True)
    if x.ndim == 3:
        mesh_op = _mesh_op_maybe(ps, qs, int(x.shape[0]), int(x.shape[1]),
                                 backend if op is None else op.backend)
        if mesh_op is not None:
            return mesh_op(x, factors)
    if op is None:
        op = kron_op_for(ps, qs, batch=int(x.shape[0]), shared_factors=True,
                         backend=backend, plan=plan)
    return op(x, factors)


def balanced_factorization(d: int, n: int) -> tuple[int, ...]:
    """Split ``d`` into ``n`` integer factors as geometrically balanced as
    possible (largest factors first).  Exact: prod(out) == d."""
    if n <= 0:
        raise ValueError("n must be >= 1")
    if d <= 0:
        raise ValueError(f"d must be a positive dimension, got {d}")
    primes: list[int] = []
    x = d
    f = 2
    while f * f <= x:
        while x % f == 0:
            primes.append(f)
            x //= f
        f += 1
    if x > 1:
        primes.append(x)
    out = [1] * n
    for p in sorted(primes, reverse=True):
        # the next prime goes on the currently smallest bucket
        out[min(range(n), key=lambda i: out[i])] *= p
    return tuple(sorted(out, reverse=True))


@dataclass(frozen=True)
class KronLinearSpec:
    ps: tuple[int, ...]
    qs: tuple[int, ...]
    use_bias: bool = False

    @property
    def d_in(self) -> int:
        return math.prod(self.ps)

    @property
    def d_out(self) -> int:
        return math.prod(self.qs)

    @property
    def n_params(self) -> int:
        return sum(p * q for p, q in zip(self.ps, self.qs)) + (
            self.d_out if self.use_bias else 0
        )

    @classmethod
    def balanced(
        cls, d_in: int, d_out: int, n_factors: int = 2, use_bias: bool = False
    ) -> "KronLinearSpec":
        return cls(
            balanced_factorization(d_in, n_factors),
            balanced_factorization(d_out, n_factors),
            use_bias,
        )

    def op(self, **op_kwargs) -> KronOp:
        """The (shared, bounded-cached) KronOp executing this projection."""
        return kron_op_for(self.ps, self.qs, **op_kwargs)


def kron_linear_init(
    generator: torch.Generator | None,
    spec: KronLinearSpec,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> dict:
    """Init so the composed operator matches dense fan-in scaling:
    Var(W) = prod Var(F^i) = 1/d_in  =>  std_i = d_in^(-1/(2N)).  The
    factors are drawn from ``generator`` (on ``device``) in f32, then cast."""
    n = len(spec.ps)
    std = spec.d_in ** (-1.0 / (2 * n))

    def normal(p, q):
        t = torch.randn(p, q, generator=generator, device=device, dtype=torch.float32)
        return (t * std).to(dtype)

    params = {"factors": tuple(normal(p, q) for p, q in zip(spec.ps, spec.qs))}
    if spec.use_bias:
        params["bias"] = torch.zeros(spec.d_out, dtype=dtype, device=device)
    return params


def kron_linear_apply(
    params: dict, x: torch.Tensor, *, backend: str = "auto", plan="auto",
    op: KronOp | None = None,
) -> torch.Tensor:
    """``x @ W (+ bias)`` for ``x: (..., d_in)``.  A batch of three or more
    dims ``(B, ..., d_in)`` runs the shared-factor batched op (B and the
    other leading dims fold into the rows: one launch per stage for the
    whole batch), inside a ``kron_distributed`` scope the scope's mesh op
    for a 3-D ``x``; a 2-D ``x`` the single op.  ``op``, an op already
    resolved for these factors (``KronLinear``'s), runs in place of one
    from ``kron_op_for``; ``backend`` and ``plan`` are then its own."""
    factors = tuple(params["factors"])
    if x.ndim >= 3:
        y = _apply_batched_maybe_distributed(factors, x, backend, plan, op)
    else:
        if op is None:
            ps, qs = signature_of(factors, shared_factors=True)
            op = kron_op_for(ps, qs, backend=backend, plan=plan)
        y = op(x, factors)
    if "bias" in params:
        y = y + params["bias"]
    return y


def kron_linear_apply_batched(
    params: dict, x: torch.Tensor, *, backend: str = "auto", plan="auto"
) -> torch.Tensor:
    """Per-sample KronLinear: one factor set per batch element (per-expert
    Kronecker projections).  ``params["factors"][i]: (B, P_i, Q_i)``,
    ``x: (B, ..., d_in)``; an optional bias is ``(d_out,)`` or ``(B, d_out)``.
    """
    factors = tuple(params["factors"])
    ps, qs = signature_of(factors, shared_factors=False)
    op = kron_op_for(ps, qs, batch=int(x.shape[0]), shared_factors=False,
                     backend=backend, plan=plan)
    y = op(x, factors)
    if "bias" in params:
        bias = params["bias"]
        if bias.ndim == 2:  # a per-sample bias broadcasts over the lead dims
            bias = bias.reshape(bias.shape[0], *([1] * (y.ndim - 2)), -1)
        y = y + bias
    return y


class KronLinear(nn.Module):
    """A Kronecker-factored projection as an ``nn.Module``: the spec, the
    factors (an ``nn.ParameterList``, problem order), an optional bias
    (``nn.Parameter``) and the ``KronOp`` resolved once here, not per call
    (``m`` pre-plans that row count).  ``forward`` takes ``(..., d_in)`` of
    any rank: leading dims fold into the op's rows.  ``params`` (the
    reference's dict) runs the op on other factors in place of the
    module's own."""

    def __init__(
        self,
        generator: torch.Generator,
        spec: KronLinearSpec,
        dtype: torch.dtype = torch.float32,
        *,
        device: str | torch.device = "cuda",
        backend: str = "auto",
        m: int | None = None,
    ):
        super().__init__()
        self.spec = spec
        init = kron_linear_init(generator, spec, dtype, device)
        self.factors = nn.ParameterList(nn.Parameter(f) for f in init["factors"])
        self.bias = nn.Parameter(init["bias"]) if spec.use_bias else None
        self.op = kron_op_for(spec.ps, spec.qs, m=m, backend=backend)

    @property
    def params(self) -> dict:
        """The module's parameters in the reference's dict form."""
        out = {"factors": tuple(self.factors)}
        if self.bias is not None:
            out["bias"] = self.bias
        return out

    def forward(self, x: torch.Tensor, params: dict | None = None) -> torch.Tensor:
        return kron_linear_apply(self.params if params is None else params, x, op=self.op)


def kron_linear_materialize(params: dict) -> torch.Tensor:
    """Dense ``(d_in, d_out)`` equivalent: test oracle / export."""
    factors: Sequence[torch.Tensor] = tuple(params["factors"])
    w = factors[0]
    for f in factors[1:]:
        w = torch.kron(w, f)
    return w


__all__ = [
    "KronLinearSpec",
    "KronLinear",
    "kron_linear_init",
    "kron_linear_apply",
    "kron_linear_apply_batched",
    "kron_linear_materialize",
    "kron_distributed",
    "balanced_factorization",
]
