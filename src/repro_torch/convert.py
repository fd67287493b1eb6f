"""Carrying state across from the JAX package.

What the two packages share is the factors, the plans and the parameters
of the layers built on them: a KronLinear's ``{"factors": ..., "bias": ...}``
and an FFN block's ``{"w1", "w3", "w2"}``.  Each converter takes the JAX
package's arrays as numpy (``np.asarray`` of each leaf) and puts them on a
device; none imports the JAX package.  ``jax.random`` and
``torch.Generator`` draw different numbers from one seed, so parity between
the packages always goes through these converters.

  * ``factors_from_numpy``: factor arrays as tensors;
  * ``kron_linear_params_from_numpy`` / ``ffn_params_from_numpy``: the
    parameter dicts;
  * ``load_kron_linear_``: fill a ``KronLinear`` module's parameters;
  * ``model_params_from_numpy``: a whole model's parameter tree
    (``repro.models.model.init_params``' stacked layout, bf16 included;
    MoE and Mamba leaves in their own dtypes, the router and the SSM's
    decay parameters f32);
  * ``cache_from_numpy``: a decode cache (``repro.models.model.init_cache``
    / ``prefill``'s ``KVCache``, ``QuantKVCache`` and ``MambaCache``) as
    the port's;
  * ``opt_state_from_numpy``: an AdamW or Shampoo state (``m``/``v``/
    ``step``, the ``kron`` subtree, ``err``);
  * ``plan_from_jax_json``: a ``repro.core.autotune.plan_to_json`` dict as
    the port's ``KronPlan``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.autotune import KronPlan, plan_from_json


def _device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available here; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev


def factors_from_numpy(
    arrays: Sequence[np.ndarray],
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, ...]:
    """Factor arrays (problem order) as tensors on ``device``, in ``dtype``
    (None keeps each array's own dtype)."""
    dev = _device(device)
    return tuple(_tensor(a, dev, dtype) for a in arrays)


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a)  # a copy: numpy views of JAX arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carried as raw words
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor(a, dev: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    return _as_tensor(a).to(device=dev, dtype=dtype)


def kron_linear_params_from_numpy(
    params: dict,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> dict:
    """A KronLinear parameter dict (``{"factors": (F^1, ...)}`` and an
    optional ``"bias"``, numpy leaves) as tensors on ``device`` in
    ``dtype`` (None keeps each array's own)."""
    dev = _device(device)
    out = {"factors": tuple(_tensor(f, dev, dtype) for f in params["factors"])}
    if "bias" in params:
        out["bias"] = _tensor(params["bias"], dev, dtype)
    return out


def ffn_params_from_numpy(
    params: dict,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> dict:
    """An FFN block's ``{"w1", "w3", "w2"}`` (``repro.models.ffn.ffn_init``'s
    layout, numpy leaves): KronLinear dicts for ``kron_ffn``, dense
    ``(d_in, d_out)`` matrices otherwise."""
    dev = _device(device)
    return {
        name: (kron_linear_params_from_numpy(p, device=dev, dtype=dtype)
               if isinstance(p, dict) else _tensor(p, dev, dtype))
        for name, p in params.items()
    }


def _tree_from_numpy(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev, None)


def model_params_from_numpy(params: dict, *, device: str | torch.device = "cuda") -> dict:
    """A model's parameter tree (``repro.models.model.init_params``'
    layout, numpy leaves, bf16 as ``ml_dtypes`` arrays) as tensors on
    ``device``, each leaf in its own dtype."""
    return _tree_from_numpy(params, _device(device))


def cache_from_numpy(cache: dict, *, device: str | torch.device = "cuda") -> dict:
    """A decode cache of the JAX package (numpy leaves, its NamedTuples
    kept, e.g. ``jax.tree.map(np.asarray, cache)``) as the port's: each
    ``KVCache``/``QuantKVCache``/``MambaCache`` as the port's NamedTuple of
    the same fields, every leaf on ``device`` in its own dtype."""
    from .models.attention import KVCache, QuantKVCache
    from .models.ssm import MambaCache

    dev = _device(device)
    kinds = {cls._fields: cls for cls in (KVCache, QuantKVCache, MambaCache)}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields is not None:
            if fields not in kinds:
                raise ValueError(f"not a cache of the JAX package: {type(node).__name__}{fields}")
            return kinds[fields](*(_tensor(getattr(node, f), dev, None) for f in fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _tensor(node, dev, None)

    return walk(cache)


def opt_state_from_numpy(state: dict, *, device: str | torch.device = "cuda") -> dict:
    """An optimizer state (``repro.optim.opt_init`` / ``shampoo_init``
    layout, numpy leaves) as tensors: the step counter on the host, as the
    port keeps it, every other leaf on ``device``."""
    out = _tree_from_numpy(state, _device(device))
    out["step"] = _as_tensor(state["step"]).to(dtype=torch.int32)
    return out


def load_kron_linear_(module, params: dict):
    """Copy a KronLinear parameter dict (numpy or tensor leaves) into a
    ``core.layers.KronLinear`` module's parameters, in place, on the
    module's device and dtype; returns the module."""
    factors = tuple(params["factors"])
    if len(factors) != len(module.factors):
        raise ValueError(f"{len(factors)} factors for a module of {len(module.factors)}")
    if ("bias" in params) != (module.bias is not None):
        raise ValueError("bias present in one of the params and the module only")
    with torch.no_grad():
        for dst, src in zip(module.factors, factors):
            src = _as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"factor shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)
        if module.bias is not None:
            module.bias.copy_(_as_tensor(params["bias"]))
    return module


def plan_from_jax_json(d: dict) -> KronPlan:
    """The port's ``KronPlan`` for a dict from
    ``repro.core.autotune.plan_to_json``."""
    return plan_from_json(d)


__all__ = [
    "factors_from_numpy",
    "kron_linear_params_from_numpy",
    "ffn_params_from_numpy",
    "load_kron_linear_",
    "model_params_from_numpy",
    "cache_from_numpy",
    "opt_state_from_numpy",
    "plan_from_jax_json",
]
