"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o <name>.so csrc/<name>.cu

Libraries go to ``build/torch_kernels/<hash>/`` at the root of the checkout,
keyed by a hash of every file in ``csrc/`` and the flags, and are built at
the first CUDA launch — never at import.  All sources compile at once, one
``nvcc`` each.  ptxas's register and shared-memory report for each library
is kept beside it as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("chain_fwd", "chain_bwd", "grad", "sliced", "sliced_t", "cg_update")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_root() -> Path:
    """``build/torch_kernels`` at the root of the checkout (src/../build)."""
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return build_root() / _digest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
            "are built at their first launch and need the CUDA toolkit"
        )
    return str(path)


def build_all() -> dict[str, Path]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns ``{name: path of the .so}``.  A failed compile raises with the
    compiler's output.  Each library is written under a temporary name and
    renamed, so a concurrent build never loads a half-written file.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"{name}.so" for name in SOURCES}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for lib_name, path in paths.items():
                if lib_name not in _LIBS:
                    _LIBS[lib_name] = ctypes.CDLL(str(path))
        return _LIBS[name]


def error_string(lib: ctypes.CDLL, code: int) -> str:
    fn = lib.kron_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


__all__ = ["CSRC", "SOURCES", "build_all", "build_dir", "library", "error_string"]
