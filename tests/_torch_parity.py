"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs are made once with numpy from a seed and handed to both packages, so
the JAX reference and the PyTorch port see the same numbers.
"""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import torch


def make_inputs(seed, m, ps, qs, *, batch=None, dtype=np.float64):
    """numpy ``x (..., m, prod(ps))`` and factors ``(..., p_i, q_i)``."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = rng.standard_normal((*lead, m, math.prod(ps))).astype(dtype)
    fs = [rng.standard_normal((*lead, p, q)).astype(dtype) for p, q in zip(ps, qs)]
    return x, fs


def jax_gate(cfg):
    """The port's config with the JAX package's MoE gate: the reference
    renormalizes the top-k gates of every model, while the port's
    deepseek-moe-16b keeps the published unrenormalized gate
    (``norm_topk=False``), a kept difference.  Held against the reference,
    a port config takes ``norm_topk=True``."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, norm_topk=True))


def to_jax(a, dtype=None):
    return jnp.asarray(a, dtype=dtype)


def to_torch(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype)


def assert_close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|), compared in f64."""
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"max err {err:.3e} > {tol:g} * {scale:.3e}"


def jax_tree(t):
    """A tree of the port's (dicts, lists, tuples of CPU tensors) as the
    same tree of JAX arrays: parameters drawn once by the port, handed to
    both packages."""
    if isinstance(t, dict):
        return {k: jax_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(jax_tree(v) for v in t)
    return jnp.asarray(t.detach().numpy())


def model_params(cfg, seed=0):
    """Reduced-model parameters from the port's init (a CPU generator),
    as ``(jax tree, torch tree)``: JAX's own init of the reduced stacks
    costs seconds a config on the CPU."""
    from repro_torch.models import model as TM

    tp = TM.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return jax_tree(tp), tp
