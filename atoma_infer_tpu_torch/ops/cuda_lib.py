"""Build and load the port's hand-written CUDA kernels.

Every ``atoma_infer_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and loaded
with ``ctypes``. Nothing here includes PyTorch's headers, so one source
builds in seconds. Builds go to ``csrc/build/`` (ignored by git), named by a
hash of the source and flags, so an edited source is never served a stale
library. A build happens at a kernel's first launch, or up front (all sources
in parallel, one ``nvcc`` each) through :func:`build_all`.

Each kernel is a :class:`CudaKernel`: its C symbol, the library it lives in,
its argument types, and a plain-integer launch counter that its wrapper bumps
once per launch (and nowhere else), so a run can show which kernels the main
path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# ctypes shorthands for kernel signatures.
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from atoma_infer_tpu_torch/csrc at first use"
        )
    return found


def _lib_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _start_build(source: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` on one source unless its library is already built."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.out_path, proc.tmp_path, proc.source = out, tmp, source
    return proc


def _finish_build(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {proc.source}:\n{log}")
    os.replace(proc.tmp_path, proc.out_path)
    return log


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every kernel source (default: all of ``csrc/*.cu``) with one
    ``nvcc`` process per source, all started together. Returns each built
    source's compiler log (``-Xptxas -v``: registers, shared memory, spills);
    sources already built are skipped."""
    if sources is None:
        sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    with _lock:
        procs = [p for p in (_start_build(s) for s in sources) if p is not None]
        return {p.source: _finish_build(p) for p in procs}


def load(source: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            proc = _start_build(source)
            if proc is not None:
                _finish_build(proc)
            lib = ctypes.CDLL(str(_lib_path(source)))
            _libs[source] = lib
        return lib


class CudaKernel:
    """One C entry point of a ``csrc`` library plus its launch counter."""

    def __init__(
        self,
        name: str,
        source: str,
        symbol: str,
        argtypes: List,
        replaces: str,
    ):
        self.name = name
        self.source = source          # file under csrc/
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces      # the TPU kernel it replaces (file:line)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch (arguments already validated by the wrapper) and count it;
        raises on a nonzero ``cudaGetLastError`` from the C entry point."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} ({self.symbol}) failed to launch: "
                f"error {err}"
            )
        self.launches += 1


KERNELS: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def current_stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

