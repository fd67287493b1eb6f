"""Shampoo-style Kron-factored preconditioning through the KronOp engine.

The port of ``repro.optim.shampoo``.  The preconditioned update ``P =
L^{-1/4} G R^{-1/4}`` is a Kron-Matmul: with the row-major flattening
``vec_row(A^T G B) = vec_row(G) @ (A (x) B)``, every layer's apply is one
row of ``x @ (Lroot (x) Rroot)``.  So the apply groups same-shape layers
and runs ONE per-sample batched ``KronOp`` call per shape group
(``engine.kron_precond_op``): on CUDA tensors, the chain kernels.

Per step, as the reference (ineligible leaves get EXACTLY AdamW):

1. statistics ``L += G G^T``, ``R += G^T G`` (or an EMA, ``stats_beta``)
   from the clipped gradient, stored in ``state_dtype``;
2. on the refresh steps (optimizer step 1 and every ``precond_every``-th)
   the inverse quarter roots, by ``torch.linalg.eigh`` or coupled Newton
   (``root_method``).  The reference decides inside its jitted step with
   ``lax.cond``; here the step counter lives on the host and a Python
   branch decides, so the chaos site ``root_refresh``, the
   ``optim.root_refresh`` span and the numerics report fire on every
   refresh (the reference's fire once, when the step is traced);
3. precondition the Adam direction ``u = m^/(sqrt(v^)+eps)`` through the
   shape-grouped batched op, then graft the AdamW step size back: ``u_sh =
   P * ||u|| / ||P||``.  A failed, stale or non-finite refresh clears the
   layer's ``ok`` flag and the layer takes ``u`` for the interval (guard
   event ``root_refresh_degraded``).

Eligibility: 2-D leaves ``(p, q)`` (one layer) and stacked 3-D leaves ``(S,
p, q)`` (S layers) with ``min_precond_dim <= p, q <= max_precond_dim``.  In
the stacked model tree that includes the ``(n_layers, head_dim)`` qk-norm
scales, as in the reference.

State: ``{"m", "v", "step"}`` as AdamW plus ``"kron"``, keyed by the
``/``-joined leaf paths, with per-layer ``l``/``r`` statistics,
``lroot``/``rroot`` roots, ``ok`` flags and ``stale`` counters.

On a mesh (``shardings``) ``m``/``v`` are shards and the ``kron`` subtree
is replicated: an eligible leaf's clipped gradient and Adam direction are
gathered whole, every rank computes the same statistics, roots and batched
``kron_precond_op`` call, and each applies its shard of the grafted
update.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import tree
from ..runtime import chaos, guard, sharding, telemetry
from .adamw import (
    OptConfig, _apply, _clipped, _compressed, _moments, lr_at, opt_init, opt_update,
)

_TINY = 1e-30  # graft-ratio denominator floor: never divides by exact zero


@dataclass(frozen=True)
class ShampooConfig(OptConfig):
    """AdamW knobs plus the Kron-preconditioner cadence/conditioning knobs."""

    precond_every: int = 20      # inverse-root refresh cadence (steps)
    stats_beta: float = 0.95     # EMA on L/R; 1.0 = classic sum accumulation
    matrix_eps: float = 1e-2     # relative ridge (damped whitening)
    root_method: str = "eigh"    # "eigh" | "newton" (coupled iteration)
    newton_iters: int = 25       # coupled-Newton iterations
    max_precond_dim: int = 1024  # rank shortlist: larger dims fall to AdamW
    min_precond_dim: int = 4     # smaller dims (stacked norms/biases) too


# ---------------------------------------------------------------------------
# Eligibility / shape grouping
# ---------------------------------------------------------------------------


def _eligible(shape, cfg: ShampooConfig):
    """``(S, p, q)`` for a precondition-eligible leaf shape, else None:
    2-D ``(p, q)`` leaves are one layer, 3-D ``(S, p, q)`` leaves S."""
    if len(shape) == 2:
        s, (p, q) = 1, shape
    elif len(shape) == 3:
        s, p, q = shape
    else:
        return None
    if min(p, q) < cfg.min_precond_dim or max(p, q) > cfg.max_precond_dim:
        return None
    return int(s), int(p), int(q)


def shape_groups(params: Any, cfg: ShampooConfig) -> dict:
    """``{(p, q): [(path, S), ...]}`` over precondition-eligible leaves, in
    flatten order.  Each group becomes ONE batched per-sample ``KronOp``
    call of batch ``sum(S)`` in the update."""
    groups: dict = {}
    for path, leaf in tree.leaves_with_path(params):
        spq = _eligible(tuple(leaf.shape), cfg)
        if spq is None:
            continue
        s, p, q = spq
        groups.setdefault((p, q), []).append((path, s))
    return groups


def prewarm(params: Any, cfg: ShampooConfig) -> tuple:
    """Construct the shape-group ops before the first step (their plans
    land in the engine's bounded memo).  ``params`` may be ``meta``
    tensors."""
    from ..core.engine import kron_precond_op

    return tuple(
        kron_precond_op(p, q, sum(s for _, s in members))
        for (p, q), members in shape_groups(params, cfg).items()
    )


# ---------------------------------------------------------------------------
# Inverse quarter roots
# ---------------------------------------------------------------------------


def _ridge_of(s: torch.Tensor, eps: float) -> torch.Tensor:
    """Relative ridge ``eps * lambda_max-upper-bound`` (the symmetric
    inf-norm) with an absolute floor, per ``(d, d)`` matrix of ``s``; all-
    zero statistics then give a multiple of the identity, which grafting
    maps to exactly the AdamW step."""
    lam = s.abs().sum(-1).amax(-1)
    return eps * torch.clamp(lam, min=eps)


def _sym(a: torch.Tensor) -> torch.Tensor:
    return (a + a.mT) * 0.5


def _eye_like(s: torch.Tensor) -> torch.Tensor:
    return torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)


def _root_eigh(s: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S^{-1/4}, ok)`` by eigendecomposition, for a stack ``(B, d, d)``."""
    s = _sym(s)
    ridge = _ridge_of(s, eps)
    # LAPACK and cusolver raise on a non-finite matrix where XLA returns
    # NaNs: such a layer is decomposed as the identity and flagged not ok.
    finite = torch.isfinite(s).all(-1).all(-1)
    a = torch.where(finite[:, None, None], s + ridge[:, None, None] * _eye_like(s),
                    _eye_like(s))
    w, v = torch.linalg.eigh(a)
    ok = (finite & torch.isfinite(w).all(-1) & torch.isfinite(v).all(-1).all(-1)
          & (w[:, -1] > 0))
    w = torch.maximum(w, ridge[:, None] * torch.finfo(s.dtype).eps)
    root = _sym((v * (w ** -0.25)[:, None, :]) @ v.mT)
    return root, ok & torch.isfinite(root).all(-1).all(-1)


def _root_newton(s: torch.Tensor, eps: float, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S^{-1/4}, ok)`` by the coupled-Newton iteration for inverse p-th
    roots (p=4), for a stack ``(B, d, d)``: ``X <- X T, M <- T^p M`` with
    ``T = ((p+1)I - M)/p``, converging to ``(zS)^{-1/p}`` for ``z =
    1/||S||``."""
    p = 4
    s = _sym(s)
    eye = _eye_like(s)
    a = s + _ridge_of(s, eps)[:, None, None] * eye
    z = (1.0 / torch.clamp(torch.linalg.matrix_norm(a), min=_TINY))[:, None, None]
    x, m = eye.expand_as(a), z * a
    for _ in range(iters):
        t = ((p + 1) * eye - m) / p
        t2 = t @ t
        x, m = x @ t, (t2 @ t2) @ m
    root = _sym(x * (z ** (1.0 / p)))
    # converged: M -> I (the coupled invariant); a loose gate, the graft
    # fallback catches anything this lets through
    ok = torch.isfinite(root).all(-1).all(-1) & ((m - eye).abs().amax((-2, -1)) < 0.1)
    return root, ok


def inverse_quarter_root(
    stat: torch.Tensor, *, eps: float = 1e-2, method: str = "eigh", iters: int = 25
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S^{-1/4}, ok)`` for a stacked ``(S, d, d)`` (or one ``(d, d)``)
    PSD statistic; ``ok`` is a per-layer validity flag (finite, converged)."""
    if method == "eigh":
        fn = lambda m: _root_eigh(m, eps)  # noqa: E731
    elif method == "newton":
        fn = lambda m: _root_newton(m, eps, iters)  # noqa: E731
    else:
        raise guard.PlanError(f"unknown root_method {method!r}: want 'eigh' or 'newton'")
    if stat.ndim == 2:
        root, ok = fn(stat[None])
        return root[0], ok[0]
    return fn(stat)


# ---------------------------------------------------------------------------
# Preconditioner application (the KronOp hot path)
# ---------------------------------------------------------------------------


def _groups_of_kron(kron: dict) -> dict:
    """Shape groups recovered from the kron state subtree (stable order)."""
    groups: dict = {}
    for path in kron:
        s, p, _ = kron[path]["lroot"].shape
        q = kron[path]["rroot"].shape[-1]
        groups.setdefault((p, q), []).append((path, s))
    return groups


def precondition(
    updates: dict, kron: dict, *, looped: bool = False, backend: str = "auto"
) -> dict:
    """Apply ``Lroot^T u Rroot`` to every layer: ``{path: (S, p, q)}`` in,
    same-keyed dict out.

    ``looped=False``: ONE per-sample batched ``KronOp`` per shape group over
    the stacked layers.  ``looped=True``: one single-sample call per layer,
    which the batched path equals bitwise (no tile splits the contraction
    dim, so every sum runs in the same order).  ``backend`` is the ops'
    (``"torch"``: the kernels' plain twins).
    """
    from ..core.engine import kron_precond_op

    out: dict = {}
    for (p, q), members in _groups_of_kron(kron).items():
        if looped:
            op = kron_precond_op(p, q, 1, backend=backend)
            for path, s in members:
                u = updates[path].reshape(s, 1, 1, p * q)
                lr_, rr_ = kron[path]["lroot"], kron[path]["rroot"]
                ys = [op(u[i], (lr_[i:i + 1], rr_[i:i + 1])) for i in range(s)]
                out[path] = torch.cat(ys, dim=0).reshape(s, p, q)
            continue
        b = sum(s for _, s in members)
        x = torch.cat([updates[path].reshape(s, 1, p * q) for path, s in members])
        ls = torch.cat([kron[path]["lroot"] for path, _ in members])
        rs = torch.cat([kron[path]["rroot"] for path, _ in members])
        y = kron_precond_op(p, q, b, backend=backend)(x, (ls, rs)).reshape(b, p, q)
        off = 0
        for path, s in members:
            out[path] = y[off:off + s]
            off += s
    return out


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------


def shampoo_init(params: Any, cfg: ShampooConfig) -> dict:
    """AdamW state plus the ``kron`` subtree.  Roots start at identity with
    ``ok=True``: the first interval IS the grafted-AdamW step."""
    state = opt_init(params, cfg)
    state["kron"] = kron_state_init(params, cfg)
    return state


def kron_state_init(params: Any, cfg: ShampooConfig) -> dict:
    """The ``kron`` subtree of ``shampoo_init``: eligibility by each leaf's
    (whole) shape; on a mesh, every rank holds all of it."""
    sd = getattr(torch, cfg.state_dtype)
    kron: dict = {}
    for path, leaf in tree.leaves_with_path(params):
        spq = _eligible(tuple(leaf.shape), cfg)
        if spq is None:
            continue
        s, p, q = spq
        dev = leaf.device
        eye = lambda d: torch.eye(d, device=dev).expand(s, d, d).clone()  # noqa: E731 (f32)
        kron[path] = {
            "l": torch.zeros(s, p, p, dtype=sd, device=dev),
            "r": torch.zeros(s, q, q, dtype=sd, device=dev),
            "lroot": eye(p),
            "rroot": eye(q),
            "ok": torch.ones(s, dtype=torch.bool, device=dev),
            "stale": torch.zeros(s, dtype=torch.int32, device=dev),
        }
    return kron


def _refresh_leaf(entry: dict, l32, r32, cfg: ShampooConfig):
    """New ``(lroot, rroot, ok, did, n_bad)`` for one leaf's stacked layers
    on a refresh step.  A chaos-injected ``NumericsError`` (site
    ``root_refresh``) degrades the leaf to its grafted-AdamW fallback for
    the interval, recorded in guard health, never crashing the step."""
    s = entry["ok"].shape[0]
    dev = entry["ok"].device
    try:
        chaos.maybe_fail("root_refresh")
    except guard.NumericsError as e:
        guard.record_event("root_refresh_degraded", e)
        guard.warn_once(
            ("root_refresh", "chaos"),
            f"shampoo: inverse-root refresh failed ({e}) — layer degraded "
            f"to grafted AdamW for this interval",
        )
        none = torch.zeros(s, dtype=torch.bool, device=dev)
        return (entry["lroot"], entry["rroot"], none, none,
                torch.zeros((), dtype=torch.int32, device=dev))
    nl, okl = inverse_quarter_root(
        l32, eps=cfg.matrix_eps, method=cfg.root_method, iters=cfg.newton_iters)
    nr, okr = inverse_quarter_root(
        r32, eps=cfg.matrix_eps, method=cfg.root_method, iters=cfg.newton_iters)
    ok = okl & okr
    sel = ok[:, None, None]
    return (torch.where(sel, nl, entry["lroot"]), torch.where(sel, nr, entry["rroot"]),
            ok, ok, (~ok).sum(dtype=torch.int32))


def _report_refresh_failures(n_bad, policy: str) -> None:
    """The numerics report of a refresh: a guard event, then a raise or a
    once-per-process warning by ``policy``."""
    n = int(n_bad)
    if n <= 0:
        return
    msg = (
        f"shampoo inverse-root refresh produced {n} invalid root pair(s) "
        f"(non-finite or non-positive statistics) — affected layers "
        f"degraded to grafted AdamW until the next refresh"
    )
    guard.record_event("root_refresh_degraded", guard.NumericsError(msg))
    if policy == "raise":
        raise guard.NumericsError(msg)
    guard.warn_once(("root_refresh", "nonfinite"), f"kron guard: {msg}")


def _whole(t: torch.Tensor, sh) -> torch.Tensor:
    """A leaf's whole tensor from this rank's shard (as it is off the mesh)."""
    if sh is None or all(e is None for e in sh.spec):
        return t
    return sharding.gather_shards(t, sh)


@torch.no_grad()
def shampoo_update(
    grads: Any, state: dict, params: Any, cfg: ShampooConfig, *, backend: str = "auto",
    shardings: Any = None,
) -> tuple[Any, dict, dict]:
    """Returns ``(new_params, new_state, metrics)``, AdamW's contract.

    Ineligible leaves run the exact AdamW update; eligible leaves swap the
    Adam direction for its grafted Kron-preconditioned image (one batched
    ``KronOp`` call per shape group; ``backend`` is the ops').
    ``shardings``: the parameters' ``NamedSharding`` tree when the trees
    hold shards.
    """
    grads, new_err, gnorm, scale = _compressed(grads, state, cfg, shardings)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    sd = getattr(torch, cfg.state_dtype)
    kron = state["kron"]
    n_step = int(step)
    refresh = n_step == 1 or n_step % max(cfg.precond_every, 1) == 0

    # Adam moments + direction for EVERY leaf; an ineligible leaf's update
    # is applied at once, an eligible one's direction waits for its group.
    flat = tree.leaves_with_path(params)
    shs = [None] * len(flat) if shardings is None else tree.leaves(shardings)
    new_p: list = [None] * len(flat)
    new_m, new_v, u_adam, g_kron = [], [], {}, {}
    for i, ((path, p_), g, m, v) in enumerate(zip(
            flat, tree.leaves(grads), tree.leaves(state["m"]), tree.leaves(state["v"]))):
        g = _clipped(g, scale)
        m32, v32 = _moments(g, m, v, b1, b2)
        new_m.append(m32.to(sd))
        new_v.append(v32.to(sd))
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if path in kron:
            u_adam[path], g_kron[path] = _whole(u, shs[i]), _whole(g, shs[i])
        else:
            new_p[i] = _apply(p_, u, lr, cfg)

    # Statistics for the eligible leaves, and the roots on a refresh step.
    new_kron: dict = {}
    n_bad: list = []  # per leaf, on the device: read only to report
    span = (telemetry.span("optim.root_refresh", every=cfg.precond_every)
            if refresh else contextlib.nullcontext())
    with span:
        for path, entry in kron.items():
            s, p, _ = entry["l"].shape
            q = entry["r"].shape[-1]
            g3 = g_kron[path].reshape(s, p, q)
            ggt = g3 @ g3.mT
            gtg = g3.mT @ g3
            l32, r32 = entry["l"].float(), entry["r"].float()
            if cfg.stats_beta >= 1.0:
                l32, r32 = l32 + ggt, r32 + gtg
            else:
                bs = cfg.stats_beta
                l32 = l32 * bs + ggt * (1 - bs)
                r32 = r32 * bs + gtg * (1 - bs)
            if refresh:
                lroot, rroot, ok, did, bad = _refresh_leaf(entry, l32, r32, cfg)
                n_bad.append(bad)
            else:
                lroot, rroot, ok = entry["lroot"], entry["rroot"], entry["ok"]
                did = torch.zeros_like(ok)
            new_kron[path] = {
                "l": l32.to(sd),
                "r": r32.to(sd),
                "lroot": lroot,
                "rroot": rroot,
                "ok": ok,
                "stale": torch.where(did, 0, entry["stale"] + 1).to(torch.int32),
            }

    policy = guard.numerics_policy()
    if refresh and policy != "off":
        _report_refresh_failures(sum(int(b) for b in n_bad), policy)

    # Shape-grouped batched preconditioning of the Adam direction + graft.
    if new_kron:
        with telemetry.span("optim.precondition", groups=len(_groups_of_kron(new_kron))):
            updates = {
                path: u_adam[path].reshape(e["ok"].shape[0], e["l"].shape[-1], e["r"].shape[-1])
                for path, e in new_kron.items()
            }
            pre = precondition(updates, new_kron, backend=backend)
            idx = {path: i for i, (path, _) in enumerate(flat)}
            for path, y3 in pre.items():
                u3 = updates[path]
                unorm = torch.sqrt(torch.sum(u3 * u3, dim=(1, 2)))
                pnorm = torch.sqrt(torch.sum(y3 * y3, dim=(1, 2)))
                grafted = y3 * (unorm / (pnorm + _TINY))[:, None, None]
                # runtime fallback: stale/failed roots OR a degenerate
                # apply (zero/non-finite norm) -> the grafted-AdamW step
                ok = new_kron[path]["ok"] & torch.isfinite(pnorm) & (pnorm > 0)
                u = torch.where(ok[:, None, None], grafted, u3).reshape(u_adam[path].shape)
                i = idx[path]
                if shs[i] is not None and u.shape != flat[i][1].shape:
                    u = sharding.local_shard(u, shs[i])
                new_p[i] = _apply(flat[i][1], u, lr, cfg)

    new_state = {
        "m": tree.unflatten_like(params, new_m),
        "v": tree.unflatten_like(params, new_v),
        "step": step,
        "kron": new_kron,
    }
    if cfg.compress:
        new_state["err"] = new_err
    if new_kron:
        stale = torch.cat([e["stale"] for e in new_kron.values()]).max()
        ok_frac = torch.cat([e["ok"] for e in new_kron.values()]).float().mean()
    else:
        stale, ok_frac = torch.zeros((), dtype=torch.int32), torch.ones(())
    metrics = {
        "grad_norm": gnorm,
        "lr": lr,
        "precond_stale_steps": stale,
        "precond_ok_frac": ok_frac,
    }
    return tree.unflatten_like(params, new_p), new_state, metrics


# ---------------------------------------------------------------------------
# Dispatch + reporting
# ---------------------------------------------------------------------------


def opt_for(cfg: OptConfig) -> tuple[Callable, Callable]:
    """``(init_fn, update_fn)`` for a config: ``ShampooConfig`` routes to
    the Kron-preconditioned path, plain ``OptConfig`` to AdamW."""
    if isinstance(cfg, ShampooConfig):
        return shampoo_init, shampoo_update
    return opt_init, opt_update


def state_memory_report(opt_state: Any) -> dict:
    """``{"total_bytes", "by_dtype": {dtype: bytes}}`` over an optimizer
    state tree (dtype names as numpy spells them: ``float32``, ...)."""
    by: dict[str, int] = {}
    for leaf in tree.leaves(opt_state):
        name = str(leaf.dtype).removeprefix("torch.")
        by[name] = by.get(name, 0) + leaf.numel() * leaf.element_size()
    return {"total_bytes": sum(by.values()), "by_dtype": by}


__all__ = [
    "ShampooConfig",
    "shampoo_init",
    "kron_state_init",
    "shampoo_update",
    "opt_for",
    "shape_groups",
    "prewarm",
    "precondition",
    "inverse_quarter_root",
    "state_memory_report",
]
