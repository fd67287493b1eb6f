"""Logical-axis sharding rules: parameter, optimizer, input and cache
layouts as DTensor placements over a ``DeviceMesh``.

The port of ``repro.runtime.sharding``.  The rules are the reference's
(MaxText-style FSDP x TP, the pod axis folded into batch/FSDP):

  * batch           -> ("pod", "data") when present, else "data"
  * TP (heads, d_ff, experts, vocab) -> "model"
  * FSDP (the non-TP matrix dim)     -> "data" (+ "pod" when it must)
  * every rule guarded by divisibility (``_fit``): an axis that does not
    divide its dim falls back to replication, so every shard is even.

``param_spec``, ``cache_spec`` and ``batch_spec`` return the reference's
``PartitionSpec`` as a plain tuple, one entry per tensor dim: an axis name,
a tuple of names (major first), or None.  ``param_shardings``,
``cache_shardings`` and ``token_sharding`` wrap it in a ``NamedSharding``
whose ``placements`` are the DTensor placements, one ``Shard(d)`` or
``Replicate()`` per mesh dim; several mesh dims on one tensor dim shard it
outermost first, which is JAX's order for a tuple entry.

The model stack runs as explicit SPMD over these layouts: a rank holds its
shard of every parameter and optimizer leaf as a plain tensor
(``local_shard`` cuts it from the full tensor with no collective,
``gather_shards`` puts the full tensor back together), and activations move
by direct ``torch.distributed`` calls (``all_reduce`` and
``all_gather_into_tensor``) at the reference's constraint sites.  Nothing
here dispatches a DTensor op: DTensor's own collectives crash under gloo
with CUDA tensors, the configuration that runs several ranks on one card.

An activation's default layout on a rank is its batch rows, replicated over
the model axis.  ``constrain`` moves it from there to the layout its roles
name (a ``"tp"`` dim keeps this rank's chunk); ``tp_join`` puts the chunks
back.  Parameters enter the compute through ``param_view``: an all-gather
over the sharded mesh dims (a ``keep_tp`` view keeps the model axis's
chunk, for a tensor-parallel site) whose backward sums the gradient over
the batch axes and cuts this rank's shard, so every gradient a rank sees is
already its shard of the global gradient.  ``reduce_tp`` (a sum over the
model axis whose backward is the identity) and ``tp_partial_grad`` (the
identity, whose backward sums over the model axis) bracket a
tensor-parallel region, as Megatron's g and f do.

``use_mesh(mesh)`` installs the ambient mesh (the reference's ``with
mesh:``); outside one, ``ambient_mesh()`` is None and ``constrain``,
``constrain_like_params`` and ``tp_size`` are no-ops, as the reference's
are.  The ambient mesh is process-wide, not per thread: the backward pass
re-runs checkpointed forwards on autograd's own thread.
"""
from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from .. import tree

# ``all_gather_single`` replaces ``all_gather_into_tensor`` in newer torch.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


# ---------------------------------------------------------------------------
# Mesh axes
# ---------------------------------------------------------------------------


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axes(mesh) -> tuple[tuple[str, ...], str]:
    """Returns (batch/fsdp axes, tp axis)."""
    names = _names(mesh)
    tp = "model" if "model" in names else names[-1]
    batch = tuple(n for n in names if n != tp)
    return batch, tp


def _dim_size(mesh, name: str) -> int:
    return int(mesh.shape[_names(mesh).index(name)])


def _size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(_dim_size(mesh, a) for a in axis)
    return _dim_size(mesh, axis)


def _entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _fit(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Drop axes that do not divide their dim; keep the rest."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % _size(mesh, ax) == 0:
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# Specs and placements
# ---------------------------------------------------------------------------


def placements_of(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that a tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    names = _names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        pos = [names.index(a) for a in _entry_axes(entry)]
        if pos != sorted(pos):
            raise ValueError(
                f"spec entry {entry!r} is not in mesh order {names}: DTensor shards "
                f"a tensor dim over several mesh dims outermost first")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(mesh, placements: Sequence, ndim: int) -> tuple:
    """The spec tuple of DTensor ``placements`` on ``mesh`` (the inverse of
    ``placements_of``)."""
    entries: list[list[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(_names(mesh), placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    ``shape``: the global shape of the leaf it was made for, where known."""

    mesh: Any
    spec: tuple
    shape: tuple[int, ...] | None = None

    @property
    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int] | None = None) -> tuple[int, ...]:
        """The local shape of a leaf of global ``shape`` (default: the
        sharding's own)."""
        shape = self.shape if shape is None else shape
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(int(n) // _size(self.mesh, _entry_axes(e)) for n, e in zip(shape, spec))


# role patterns: last path component (or two) -> (spec builder)
_MATRIX_IN_OUT = re.compile(r"\b(wq|wk|wv|w1|w3|wz|wx|wb|wc|wdt)$")
_MATRIX_OUT_IN = re.compile(r"\b(wo|w2)$")


def param_spec(
    path: str, shape: tuple[int, ...], mesh,
    *, fsdp_pods: bool = False, tied_embed: bool = False,
) -> tuple:
    """The spec of one parameter leaf, by path role + divisibility."""
    batch_axes, tp = _axes(mesh)
    fsdp = batch_axes if fsdp_pods else (batch_axes[-1],)
    fsdp = fsdp if len(fsdp) > 1 else fsdp[0]
    nd = len(shape)

    def lead_pad(spec: tuple) -> tuple:
        """Stacked (scan) leaves carry extra leading dims -> None."""
        pad = (None,) * (nd - len(spec))
        return _fit(mesh, pad + spec, shape)

    if "factors" in path:                    # KronLinear factors: tiny, replicate
        return lead_pad(())
    if path.endswith("embed"):
        # (V, D) with vocab over TP: the lookup is a masked local gather and
        # one (B, S, D) sum over the model axis, and a tied head's table is
        # already V-sharded for the logits matmul.
        return lead_pad((tp, None))
    if path.endswith("lm_head"):
        return lead_pad((fsdp, tp))          # (D, V)
    if path.endswith("router"):
        return lead_pad((fsdp, None))
    if re.search(r"\bew[123]$", path):       # MoE expert stacks (E, D, F)/(E, F, D)
        e = shape[-3]
        if e % _size(mesh, tp) == 0:
            return lead_pad((tp, fsdp, None))   # expert parallelism
        # TP inside each expert instead (Mixtral: 8 experts < 16-way model)
        if path.endswith("ew2"):
            return lead_pad((None, tp, fsdp))
        return lead_pad((None, fsdp, tp))
    if path.endswith("conv_w"):
        return lead_pad((None, tp))
    if _MATRIX_OUT_IN.search(path):
        return lead_pad((tp, fsdp))
    if _MATRIX_IN_OUT.search(path):
        return lead_pad((fsdp, tp))
    if nd >= 2:
        return lead_pad((fsdp, tp))
    # 1-D (biases, norms, A/D/dt): TP only if the dim divides
    if shape and shape[-1] % _size(mesh, tp) == 0 and shape[-1] >= 1024:
        return lead_pad((tp,))
    return lead_pad(())


def _path_str(kp) -> str:
    """A ``/``-joined leaf path from its keys (strings, indices or objects
    with ``key``/``idx``/``name``), the reference's spelling."""
    if isinstance(kp, str):
        return kp
    parts = []
    for k in kp:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        else:
            parts.append(str(k))
    return "/".join(parts)


def _map_with_path(fn, t) -> Any:
    out = [fn(path, leaf) for path, leaf in tree.leaves_with_path(t)]
    return tree.unflatten_like(t, out)


def param_shardings(
    params_shape: Any, mesh,
    *, fsdp_pods: bool = False, tied_embed: bool = False,
) -> Any:
    """A tree of ``NamedSharding`` matching a tree of tensors (or ``meta``
    tensors: only the shapes are read)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(
            path, tuple(leaf.shape), mesh, fsdp_pods=fsdp_pods, tied_embed=tied_embed),
            tuple(leaf.shape)),
        params_shape,
    )


def batch_spec(mesh) -> tuple:
    batch_axes, _ = _axes(mesh)
    ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return (ax,)


def token_sharding(mesh, batch: int) -> NamedSharding:
    """(B, S) tokens: batch over (pod, data) if divisible."""
    batch_axes, _ = _axes(mesh)
    ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if batch % _size(mesh, ax) == 0:
        return NamedSharding(mesh, (ax, None))
    if batch % _size(mesh, batch_axes[-1]) == 0:
        return NamedSharding(mesh, (batch_axes[-1], None))
    return NamedSharding(mesh, (None, None))


def cache_spec(path: str, shape: tuple[int, ...], mesh, batch: int) -> tuple:
    """KV / SSM cache leaves.

    Batch-shardable: (..., B, L, Hkv, hd) -> batch over data.  B == 1:
    shard the cache LENGTH over the batch axes (sequence parallelism).
    """
    batch_axes, tp = _axes(mesh)
    bax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]

    def lead_pad(spec: tuple) -> tuple:
        pad = (None,) * (nd - len(spec))
        return _fit(mesh, pad + spec, shape)

    if leaf in ("k", "v"):
        if batch % _size(mesh, bax) == 0:
            return lead_pad((bax, None, None, tp))
        return lead_pad((None, bax, None, tp))   # sequence-parallel cache
    if leaf in ("k_scale", "v_scale"):           # int8-KV scales (B,L,Hkv,1)
        if batch % _size(mesh, bax) == 0:
            return lead_pad((bax, None, None, None))
        return lead_pad((None, bax, None, None))
    if leaf == "pos":
        return lead_pad(())
    if leaf == "conv":                           # (B, w-1, conv_dim)
        if batch % _size(mesh, bax) == 0:
            return lead_pad((bax, None, tp))
        return lead_pad((None, None, tp))
    if leaf == "h":                              # (B, H, N, P)
        if batch % _size(mesh, bax) == 0:
            return lead_pad((bax, tp, None, None))
        return lead_pad((None, tp, None, None))
    return lead_pad(())


def cache_shardings(cache_shape: Any, mesh, batch: int) -> Any:
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_spec(path, tuple(leaf.shape), mesh, batch), tuple(leaf.shape)),
        cache_shape,
    )


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------


class _Ambient(NamedTuple):
    mesh: Any
    batch_axes: tuple[str, ...]


_AMBIENT: list[_Ambient] = []


@contextlib.contextmanager
def use_mesh(mesh, *, batch_axes: Sequence[str] | None = None):
    """Install ``mesh`` as the ambient mesh (the reference's ``with
    mesh:``).  ``batch_axes``: the mesh axes the rows of the batch are
    spread over (the axes of ``token_sharding``'s first entry), which the
    parameters' gradients are summed over; all non-model axes by default.
    ``mesh=None`` installs nothing."""
    if mesh is None:
        yield None
        return
    axes = _axes(mesh)[0] if batch_axes is None else tuple(batch_axes)
    _AMBIENT.append(_Ambient(mesh, axes))
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The mesh installed by ``use_mesh`` around the current call, if any."""
    return _AMBIENT[-1].mesh if _AMBIENT else None


def batch_axes() -> tuple[str, ...]:
    """The ambient mesh's batch axes (``use_mesh``); () outside one."""
    return _AMBIENT[-1].batch_axes if _AMBIENT else ()


def tp_size() -> int:
    """Model-axis size of the ambient mesh (1 outside a mesh context)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 1
    _, tp = _axes(mesh)
    return _size(mesh, tp)


def tp_rank() -> int:
    """This rank's coordinate on the ambient mesh's model axis (0 outside
    one)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 0
    return _coord(mesh)[_axes(mesh)[1]]


def _coord(mesh) -> dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not on the mesh")
    return dict(zip(_names(mesh), (int(c) for c in coord)))


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------


def _cut(full: torch.Tensor, mesh, plan: Sequence[tuple[int, tuple[str, ...]]]) -> torch.Tensor:
    """This rank's chunk of ``full`` along each ``(tensor dim, axes)`` of
    ``plan``, the axes major first (a view)."""
    coord = _coord(mesh)
    out = full
    for d, axes in plan:
        for a in axes:
            n = _dim_size(mesh, a)
            size = int(out.shape[d]) // n
            out = out.narrow(d, coord[a] * size, size)
    return out


def _gather_stacked(local: torch.Tensor, mesh, plan) -> tuple[torch.Tensor, list[int]]:
    """All-gathers of ``local`` over the axes of ``plan`` (each entry's minor
    axis first), the ranks' chunks stacked on new leading dims with no copy
    between the gathers: ``(n_k, ..., n_1, *local.shape)``, and the tensor
    dim of each leading dim, the first gathered first."""
    out, dims = local.contiguous(), []
    for d, axes in plan:
        for a in reversed(axes):
            n = _dim_size(mesh, a)
            if n > 1:
                buf = torch.empty((n, *out.shape), dtype=out.dtype, device=out.device)
                _all_gather(buf.view(-1), out.view(-1), group=mesh.get_group(a))
                out = buf
                dims.append(d)
    return out, dims


def _unstack_chunks(stacked: torch.Tensor, dims: list[int]) -> torch.Tensor:
    """``_gather_stacked``'s result as the full tensor: each leading dim,
    innermost first, merged into its tensor dim as that dim's major part."""
    out = stacked
    for d in dims:
        lead = out.ndim - 1 - (stacked.ndim - len(dims))  # the innermost leading dim
        out = out.movedim(lead, lead + d)
        shape = list(out.shape)
        shape[lead + d: lead + d + 2] = [shape[lead + d] * shape[lead + d + 1]]
        out = out.reshape(shape)
    return out


def _join(local: torch.Tensor, mesh, plan: Sequence[tuple[int, tuple[str, ...]]]) -> torch.Tensor:
    """The inverse of ``_cut``: all-gathers, minor axis first."""
    return _unstack_chunks(*_gather_stacked(local, mesh, plan)).contiguous()


def _plan(spec: tuple, skip: Sequence[str] = ()) -> list[tuple[int, tuple[str, ...]]]:
    return [(d, _entry_axes(e)) for d, e in enumerate(spec)
            if e is not None and not set(_entry_axes(e)) & set(skip)]


def local_shard(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of ``full`` by ``sharding``'s placements: a copy,
    no collective."""
    out = _cut(full, sharding.mesh, _plan(sharding.spec))
    return out.clone(memory_format=torch.contiguous_format)


def gather_shards(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor from every rank's shard (an all-gather per sharded
    mesh dim; every rank of the mesh must call it)."""
    return _join(local, sharding.mesh, _plan(sharding.spec))


# The most bytes of a leaf that ``gather_to_host`` gathers on the card at once.
_GATHER_PIECE = 256 * 2 ** 20


def gather_to_host(local: torch.Tensor, sharding: NamedSharding, *,
                   keep: bool = True) -> torch.Tensor | None:
    """``gather_shards`` onto the host, a piece at a time: the leaf is cut
    along its longest dim into pieces of at most ``_GATHER_PIECE`` bytes
    gathered, each gathered on the card (beside the smaller buffers of its
    gathers) and copied to the host, where the pieces are put in order.
    ``keep=False``: this rank takes part in the collectives and keeps
    nothing.  Every rank of the mesh must call it."""
    mesh, plan = sharding.mesh, _plan(sharding.spec)
    if local.ndim == 0:  # never sharded
        return local.detach().cpu() if keep else None
    d = max(range(local.ndim), key=lambda i: local.shape[i])
    ranks = math.prod(_dim_size(mesh, a) for _, axes in plan for a in axes)
    row_bytes = local.numel() // max(local.shape[d], 1) * local.element_size() * ranks
    step = max(1, _GATHER_PIECE // max(row_bytes, 1))
    pieces, dims = [], []
    for lo in range(0, max(local.shape[d], 1), step):  # one empty piece for an empty leaf
        stacked, dims = _gather_stacked(local.narrow(d, lo, min(step, local.shape[d] - lo)),
                                        mesh, plan)
        if keep:
            pieces.append(stacked.cpu())
        del stacked
    if not keep:
        return None
    stacked = torch.cat(pieces, dim=len(dims) + d) if len(pieces) > 1 else pieces[0]
    return _unstack_chunks(stacked, dims).contiguous()


def _all_reduce(t: torch.Tensor, mesh, axes: Sequence[str], op=None) -> torch.Tensor:
    """Sum (or ``op``) ``t`` over ``axes`` of ``mesh`` in place."""
    for a in axes:
        if _dim_size(mesh, a) > 1:
            if op is None:
                dist.all_reduce(t, group=mesh.get_group(a))
            else:
                dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def _owned(g: torch.Tensor) -> torch.Tensor:
    """A contiguous copy a collective may write in place (an incoming
    gradient can be shared with another branch of the graph)."""
    return g.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Differentiable moves
# ---------------------------------------------------------------------------


class _ParamView(torch.autograd.Function):
    """A parameter shard -> the view the compute reads: gathered over
    ``plan``; the backward sums over the batch axes and cuts this rank's
    shard (a reduce-scatter where the two meet)."""

    @staticmethod
    def forward(ctx, local, mesh, plan, reduce_axes):
        ctx.mesh, ctx.plan, ctx.reduce_axes = mesh, plan, reduce_axes
        return _join(local, mesh, plan) if plan else local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        batch = set(ctx.reduce_axes)
        early = [(d, axes) for d, axes in ctx.plan if not set(axes) & batch]
        late = [(d, axes) for d, axes in ctx.plan if set(axes) & batch]
        g = _owned(_cut(g, ctx.mesh, early))
        _all_reduce(g, ctx.mesh, ctx.reduce_axes)
        return _cut(g, ctx.mesh, late).contiguous(), None, None, None


class VIEW:
    """The sharding of a leaf that is already the full view the compute
    reads (``param_view`` returns it as it is)."""


def tp_dim(sharding) -> int | None:
    """The tensor dim that ``sharding`` cuts over a model axis of more than
    one rank (where ``param_view(keep_tp=True)`` gives this rank's chunk);
    None where it cuts none, and for ``VIEW`` or None."""
    if sharding is VIEW or sharding is None:
        return None
    _, tp = _axes(sharding.mesh)
    if _dim_size(sharding.mesh, tp) == 1:
        return None
    return next((d for d, e in enumerate(sharding.spec) if tp in _entry_axes(e)), None)


def param_view(local: torch.Tensor, sharding, *, keep_tp: bool = False) -> torch.Tensor:
    """The tensor the compute reads for a parameter shard: the full leaf
    (``keep_tp``: the model axis's chunk stays local, for a
    tensor-parallel site).  Outside a mesh context, or for a ``VIEW``
    leaf, ``local`` itself."""
    if sharding is VIEW or sharding is None or ambient_mesh() is None:
        return local
    _, tp = _axes(sharding.mesh)
    plan = _plan(sharding.spec, skip=(tp,) if keep_tp else ())
    if not plan and not batch_axes():  # whole, and no rows elsewhere to sum
        return local
    return _ParamView.apply(local, sharding.mesh, plan, batch_axes())


class _Sum(torch.autograd.Function):
    """Megatron's g: sum over mesh axes; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(_owned(x), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Megatron's f: the identity; the backward sums over mesh axes."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(_owned(g), ctx.mesh, ctx.axes), None, None


class _Chunk(torch.autograd.Function):
    """This rank's chunk along ``dim`` over the model axis; the backward
    gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return _cut(x, mesh, [(dim, (axis,))]).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _join(g, ctx.mesh, [(ctx.dim, (ctx.axis,))]), None, None, None


class _Unchunk(torch.autograd.Function):
    """All-gather along ``dim`` over the model axis; the backward keeps this
    rank's chunk (the gradient downstream is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return _join(x, mesh, [(dim, (axis,))])

    @staticmethod
    def backward(ctx, g):
        return _cut(g, ctx.mesh, [(ctx.dim, (ctx.axis,))]).contiguous(), None, None, None


class _Pick(torch.autograd.Function):
    """``index_select`` of a tensor every model-axis rank holds whole; the
    backward scatters the gradient back and sums it over the model axis
    (ranks may pick overlapping entries)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, index, axis):
        ctx.mesh, ctx.dim, ctx.index, ctx.axis = mesh, dim, index, axis
        ctx.shape = x.shape
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape).index_add_(ctx.dim, ctx.index, g)
        return _all_reduce(full, ctx.mesh, (ctx.axis,)), None, None, None, None


def _tp_mesh():
    mesh = ambient_mesh()
    if mesh is None or tp_size() == 1:
        return None, None
    return mesh, _axes(mesh)[1]


def reduce_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum this rank's partial ``x`` over the model axis (a row-parallel
    output); the backward is the identity."""
    mesh, tp = _tp_mesh()
    return x if mesh is None else _Sum.apply(x, mesh, (tp,))


def tp_partial_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over the model axis (the
    input of a column-parallel site, each rank of which adds a part)."""
    mesh, tp = _tp_mesh()
    return x if mesh is None else _SumGrad.apply(x, mesh, (tp,))


def tp_join(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model-axis chunks of ``x`` along ``dim`` put back together."""
    mesh, tp = _tp_mesh()
    return x if mesh is None else _Unchunk.apply(x, mesh, dim % x.ndim, tp)


def tp_pick(x: torch.Tensor, dim: int, index: Sequence[int]) -> torch.Tensor:
    """The entries ``index`` of ``x`` (whole on every model-axis rank) along
    ``dim``, for this rank's share of a tensor-parallel site."""
    idx = torch.as_tensor(list(index), dtype=torch.long, device=x.device)
    mesh, tp = _tp_mesh()
    if mesh is None:
        return x.index_select(dim, idx)
    return _Pick.apply(x, mesh, dim % x.ndim, idx, tp)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ambient batch axes (each rank holds its rows'
    part); the backward is the identity, so each rank's gradient covers
    its own rows and the parameters' batch sum adds them up."""
    mesh = ambient_mesh()
    axes = batch_axes()
    if mesh is None or not axes:
        return x
    return _Sum.apply(x, mesh, axes)


def batch_shards() -> int:
    """How many distinct row blocks the ambient batch axes hold (1 outside a
    mesh context)."""
    mesh = ambient_mesh()
    return 1 if mesh is None else math.prod(_dim_size(mesh, a) for a in batch_axes())


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Move an activation to the layout its roles name.

    ``logical`` names one role per dim: None (unsharded), "batch" (this
    rank's rows, which an activation already is) or "tp" (this rank's
    chunk over the model axis; the backward gathers the chunks'
    gradients).  No-op outside a mesh context and for non-dividing dims, so
    model code can call it unconditionally.
    """
    mesh, tp = _tp_mesh()
    if mesh is None:
        return x
    n = _dim_size(mesh, tp)
    for d, role in enumerate(logical):
        if role == "tp" and x.shape[d] % n == 0:
            x = _Chunk.apply(x, mesh, d, tp)
    return x


def constrain_like_params(t: Any, shardings: Any = None) -> Any:
    """Pin a params-shaped tree (gradients, accumulators) to the params'
    layouts: a leaf at its full shape is cut to this rank's shard (no
    collective), a leaf already at its shard's shape is kept.  Without
    ``shardings`` the leaves are taken as full and their specs are the
    rules' for their shapes.  No-op outside a mesh context."""
    mesh = ambient_mesh()
    if mesh is None:
        return t
    if shardings is None:
        shardings = param_shardings(t, mesh)
    out = []
    for leaf, sh in zip(tree.leaves(t), tree.leaves(shardings)):
        full = tuple(sh.shape) if sh.shape is not None else tuple(leaf.shape)
        if tuple(leaf.shape) == full and sh.shard_shape(full) != full:
            leaf = local_shard(leaf, sh)
        elif tuple(leaf.shape) != sh.shard_shape(full):
            raise ValueError(f"leaf of shape {tuple(leaf.shape)} is neither {full} "
                             f"nor its shard {sh.shard_shape(full)}")
        out.append(leaf)
    return tree.unflatten_like(t, out)


__all__ = [
    "NamedSharding",
    "param_spec",
    "param_shardings",
    "cache_spec",
    "cache_shardings",
    "token_sharding",
    "batch_spec",
    "placements_of",
    "spec_of",
    "use_mesh",
    "ambient_mesh",
    "batch_axes",
    "tp_size",
    "tp_rank",
    "constrain",
    "constrain_like_params",
    "local_shard",
    "gather_shards",
    "gather_to_host",
    "param_view",
    "tp_dim",
    "reduce_tp",
    "tp_partial_grad",
    "tp_join",
    "tp_pick",
    "batch_sum",
    "batch_shards",
]
