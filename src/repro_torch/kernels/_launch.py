"""The boundary between Python and the ``csrc/*.cu`` libraries.

``_build`` compiles and loads the libraries; this module is the one place
that calls into them.  Every launcher (``emit.chain_cuda``,
``chain_bwd_cuda``, ``grad_cuda``, ``kron_sliced.sliced_multiply_cuda``,
``kron_sliced_t.sliced_multiply_t_cuda``, ``cg_update.FusedCG``) keeps its own
geometry, tiles, output and argument list, and crosses here:

* ``require_cuda`` and ``kernel_dtype_code`` check its operands;
* ``skip`` is the step it takes once its output is allocated: an empty
  output launches nothing; otherwise the launch's FLOPs and HBM bytes
  (inputs, factors, outputs) go to the active ``hlo_cost.CostMode``s, and on
  a ``FakeTensor`` (a dry-run's trace) the launcher returns its output
  without a build, an occupancy query or a launch, and counts no launch;
* ``launch`` is one launch, inside one ``launch`` telemetry span from its
  occupancy query to its status check: the persistent grid (``grad_blocks``
  of the SMs and the memoized ``occupancy`` query), the device, the current
  stream, ``kron_<name>`` and ``check_launch``; then ``launches`` counts it.

``LIBRARIES`` describes each library: the argtypes of ``kron_<name>`` and
of ``kron_<name>_occupancy``, and the Python model of the kernel's shared
memory that the query is held to.  The models themselves stay with the
tile rules that use them (``emit.block_smem_bytes``,
``kron_sliced.sliced_smem_bytes`` and ``sliced_t_smem_bytes``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..runtime import hlo_cost, telemetry
from ..runtime.guard import LoweringError
from . import _build

_KERNEL_DTYPES = {  # (input dtype, acc dtype) -> code in csrc/kron_tile.cuh
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}
# dtype code -> (input, accumulator) bytes
CODE_BYTES = {code: (i.itemsize, a.itemsize) for (i, a), code in _KERNEL_DTYPES.items()}

# Launches of each library, +1 per launch here and nowhere else; of the
# stage backwards, ``grad_tf32`` counts those on grad_tf32_kernel, and of the
# forward chains, ``chain_tf32`` those on chain_tf32_kernel (their launchers
# count them beside).  A stage backward is two kernels, grad.cu's and its dF
# reduction, launched by one ``kron_grad``: it counts once, under ``grad``.
launches = dict.fromkeys((*_build.SOURCES, "grad_tf32", "chain_tf32"), 0)


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


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def skip(name: str, out: torch.Tensor, flops: Callable[[], int], *tensors: torch.Tensor) -> bool:
    """Whether the launcher of ``name`` returns ``out`` without a launch:
    ``out`` is empty, or ``tensors[0]`` (the launch's input) is a
    ``FakeTensor``.  Unless ``out`` is empty, reports ``flops()`` and the
    bytes of ``tensors`` (every tensor the launch reads or writes) to the
    active ``hlo_cost.CostMode``s first."""
    if out.numel() == 0:
        return True
    if hlo_cost.ACTIVE:
        hlo_cost.count_kernel(name, flops(), _nbytes(*tensors))
    return isinstance(tensors[0], FakeTensor)  # a dry-run's trace: counted, never launched


def ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def ptrs(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


# The shared-memory models of the occupancy queries: (name, input bytes,
# accumulator bytes, the query's arguments after the dtype code) -> bytes.
def _chain_smem(name, in_bytes, acc_bytes, ps, qs, t_qs, n, m, k, t_m, t_k):
    from .emit import block_smem_bytes

    return block_smem_bytes(
        t_m, t_k, ps, t_qs, acc_bytes, kind=name, q_tiled=t_qs != qs, in_bytes=in_bytes,
    )


def _grad_smem(name, in_bytes, acc_bytes, x_align, dy_align, ps, qs, n, m, k, t_m, t_k):
    from .emit import block_smem_bytes

    return block_smem_bytes(t_m, t_k, ps, qs, acc_bytes, kind="grad", in_bytes=in_bytes)


def _sliced_smem(name, in_bytes, acc_bytes, mma, m, k, p, q, t_m, t_s, t_q):
    from .kron_sliced import sliced_smem_bytes

    return sliced_smem_bytes(t_m, t_s, p, q, t_q, in_bytes, acc_bytes, bool(mma))


def _sliced_t_smem(name, in_bytes, acc_bytes, dy_align, m, s, p, q, t_m, t_s, t_q):
    from .kron_sliced import sliced_t_smem_bytes

    return sliced_t_smem_bytes(t_m, t_s, p, q, t_q, in_bytes, acc_bytes)


class Library(NamedTuple):
    """One ``csrc/<name>.cu``: the argtypes of ``kron_<name>`` (the stream
    last), those of ``kron_<name>_occupancy`` before its ``&blocks, &smem``
    (none: no occupancy query, no persistent grid), and the model its
    query's shared memory is held to."""

    args: tuple
    query: tuple = ()
    smem: Callable[..., int] | None = None


# Every pointer and the stream are c_void_p, so no 64-bit value is cut.
_LL, _I, _VP, _D = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_double
_IP, _VPP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
# kron_chain_fwd / kron_chain_bwd(dtype, in, out, fs, ps, qs, tqs, n, B, M,
# K, t_m, t_k, nblk, stream); their occupancy(dtype, ps, qs, tqs, n, M, K,
# t_m, t_k).
_CHAIN = Library(
    (_I, _VP, _VP, _VPP, _IP, _IP, _IP, _I, _LL, _LL, _LL, _I, _I, _I, _VP),
    (_I, _IP, _IP, _IP, _I, _LL, _LL, _I, _I), _chain_smem,
)
LIBRARIES = {
    "chain_fwd": _CHAIN,
    "chain_bwd": _CHAIN,
    # kron_grad(dtype, x, dy, dx, part, df, fs, ps, qs, n, B, M, K, t_m, t_k,
    # nblk, stream); kron_grad_occupancy(dtype, x, dy, ps, qs, n, M, K, t_m,
    # t_k), x and dy their addresses mod 16.
    "grad": Library(
        (_I, _VP, _VP, _VP, _VP, _VP, _VPP, _IP, _IP, _I, _LL, _LL, _LL, _I, _I, _I, _VP),
        (_I, _VP, _VP, _IP, _IP, _I, _LL, _LL, _I, _I), _grad_smem,
    ),
    # kron_sliced(dtype, mma, x, f, y, M, K, p, q, t_m, t_s, t_q, nblk,
    # stream); kron_sliced_occupancy(dtype, mma, M, K, p, q, t_m, t_s, t_q).
    "sliced": Library(
        (_I, _I, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _I, _I, _VP),
        (_I, _I, _LL, _LL, _I, _I, _I, _I, _I), _sliced_smem,
    ),
    # kron_sliced_t(dtype, dy, f, dx, M, S, p, q, t_m, t_s, t_q, nblk,
    # stream); kron_sliced_t_occupancy(dtype, dy, M, S, p, q, t_m, t_s, t_q),
    # dy its address mod 16.
    "sliced_t": Library(
        (_I, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _I, _I, _VP),
        (_I, _VP, _LL, _LL, _I, _I, _I, _I, _I), _sliced_t_smem,
    ),
    # kron_cg_update(stage, dtype, b, y, x, r, p, part, res, rows, k, chunk,
    # shift, cur, vec, stream).
    "cg_update": Library((_I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _D, _I, _I, _VP)),
}


def kernel_fn(name: str) -> ctypes._CFuncPtr:
    """``kron_<name>`` of ``csrc/<name>.cu`` (built on first use), with its
    ctypes signature from ``LIBRARIES`` set once."""
    fn = getattr(_build.library(name), f"kron_{name}")
    if fn.argtypes is None:
        fn.argtypes = list(LIBRARIES[name].args)
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise ``RuntimeError`` for a kernel's nonzero launch status."""
    if err:
        raise RuntimeError(
            f"{name} launch failed: {_build.error_string(_build.library(name), err)}"
        )


@functools.lru_cache(maxsize=1024)
def occupancy(name: str, device: torch.device, code: int, *args) -> tuple[int, int]:
    """``kron_<name>_occupancy(code, *args, &blocks, &smem)`` on ``device``:
    (blocks of the kernel per SM at the launch's threads and shared memory,
    that shared memory in bytes); memoized.  ``args`` follow the query's
    argtypes in ``LIBRARIES``, a tuple of ints where it takes an int array.
    Raises when the kernel cannot launch, and when its layout and the
    library's shared-memory model disagree."""
    lib = LIBRARIES[name]
    fn = getattr(_build.library(name), f"kron_{name}_occupancy")
    if fn.argtypes is None:
        fn.argtypes = [*lib.query, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    argv = [ints(a) if t is _IP else a for t, a in zip(lib.query, (code, *args), strict=True)]
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        check_launch(name, fn(*argv, ctypes.byref(blocks), ctypes.byref(smem)))
    if blocks.value < 1:
        raise RuntimeError(f"{name}: no block fits an SM at {smem.value} bytes of shared memory")
    model = lib.smem(name, *CODE_BYTES[code], *args)
    if smem.value != model:
        raise RuntimeError(f"{name}.cu lays out {smem.value} bytes of shared memory, the model {model}")
    return blocks.value, smem.value


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grad_blocks(sms: int, per_sm: int, tiles: int, b: int) -> int:
    """Blocks per batch sample of a persistent launch (grad.cu; the chain
    kernels and the sliced kernels with ``b=1``): as many as the card holds
    at once (``sms`` SMs times the ``per_sm`` blocks the occupancy query
    reports), shared among the ``b`` samples, never more than a sample has
    tiles and at least one.  Each block of the stage backward writes one dF
    partial."""
    return max(1, min(tiles, sms * per_sm // b))


def launch(
    name: str,
    device: torch.device,
    args: Callable[..., tuple],
    query: tuple | None = None,
    tiles: int = 1,
    b: int = 1,
) -> None:
    """One launch of ``kron_<name>`` on ``device``'s current stream, inside
    one ``launch`` span, then counted in ``launches``.

    With an occupancy ``query`` (its arguments, as ``occupancy`` takes them
    after the device) the launch runs on a persistent grid of
    ``grad_blocks(sm_count, blocks per SM, tiles, b)`` blocks per sample,
    and ``args(nblk)`` gives ``kron_<name>``'s arguments before the stream;
    without one, ``args()`` does.  ``args`` runs inside the span, so the
    ctypes arrays it builds are the launch's work.  Raises on a nonzero
    status."""
    with telemetry.span("launch"):
        if query is None:
            argv = args()
        else:
            per_sm, _ = occupancy(name, device, *query)
            argv = args(grad_blocks(sm_count(device), per_sm, tiles, b))
        with torch.cuda.device(device):
            err = kernel_fn(name)(*argv, torch.cuda.current_stream().cuda_stream)
        check_launch(name, err)
    launches[name] += 1


__all__ = [
    "CODE_BYTES",
    "LIBRARIES",
    "Library",
    "launches",
    "kernel_dtype_code",
    "require_cuda",
    "skip",
    "ints",
    "ptrs",
    "kernel_fn",
    "check_launch",
    "occupancy",
    "sm_count",
    "grad_blocks",
    "launch",
]
