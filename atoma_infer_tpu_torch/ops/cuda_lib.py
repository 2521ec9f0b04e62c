"""Build and load the port's hand-written CUDA kernels.

Every ``atoma_infer_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and loaded
with ``ctypes``. Nothing here includes PyTorch's headers, so one source
builds in seconds. Builds go to ``csrc/build/`` (ignored by git), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is never served a stale library. A build happens at a kernel's first launch, or up front (all sources
in parallel, one ``nvcc`` each) through :func:`build_all`.

Each kernel is a :class:`CudaKernel`: its C symbol, the library it lives in,
its argument types, and a plain-integer launch counter that its wrapper bumps
once per launch (and nowhere else), so a run can show which kernels the main
path went through. A launch names its device (:func:`launch_device`, from
the tensors whose pointers it passes) and runs with that device current
(:func:`call_on_device`): the runtime launches on ``cudaGetDevice()``'s
device whatever the pointers, so a pipeline stage on ``cuda:1`` must launch
there. A call made while a CUDA graph is captured launches
nothing: it is recorded in the capture's tally (:func:`recording_launches`)
instead, and every replay of that graph adds the tally
(:func:`count_replay`). A kernel whose grid has column slices (the width-512
attention kernels past a head dim of 512) also counts the slices it
launched, in ``columns``, beside ``launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Per thread: the launch tally of the CUDA graph this thread is capturing.
_capture = threading.local()

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
    """The library's path, named by a hash of the source, every header in
    ``csrc/`` (a source may include any of them) and the flags."""
    src = (CSRC_DIR / source).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
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
    source's compiler log (``-Xptxas -v``: registers, shared memory, spills),
    its first line the source's wall from the start of the build ("built in
    N s"); sources already built are skipped."""
    if sources is None:
        sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    with _lock:
        t0 = time.monotonic()
        procs = [p for p in (_start_build(s) for s in sources) if p is not None]

        def finish(proc) -> str:
            log = _finish_build(proc)
            return f"built in {time.monotonic() - t0:.1f} s\n{log}"

        with ThreadPoolExecutor(max(1, len(procs))) as pool:
            return dict(zip((p.source for p in procs), pool.map(finish, procs)))


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
        self.columns = 0              # column slices over the launches (1 each but past 512)
        self._fn = None

    def __call__(self, *args, device, columns: int = 1) -> None:
        """Launch on ``device`` (arguments already validated by the wrapper,
        ``device`` from :func:`launch_device`) with it current, and count
        it and the ``columns`` slices its grid has; raises on a nonzero
        ``cudaGetLastError`` from the C entry point."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = call_on_device(device, self._fn, *args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} ({self.symbol}) failed to launch: "
                f"error {err}"
            )
        tally = getattr(_capture, "tally", None)
        if tally is None:
            self.launches += 1
            self.columns += columns
        else:
            tally[self.name] = tally.get(self.name, 0) + 1
            tally.columns[self.name] = tally.columns.get(self.name, 0) + columns


class LaunchTally(dict):
    """A capture's kernels (name → calls) and, in ``columns``, the column
    slices of those calls (name → slices)."""

    def __init__(self):
        super().__init__()
        self.columns: Dict[str, int] = {}


KERNELS: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


@contextlib.contextmanager
def recording_launches():
    """While this thread captures a CUDA graph: the kernels called are
    recorded in the yielded tally (name → calls) and not counted, since a
    capture launches nothing."""
    if getattr(_capture, "tally", None) is not None:
        raise RuntimeError("a CUDA graph capture is already recording launches")
    _capture.tally = tally = LaunchTally()
    try:
        yield tally
    finally:
        _capture.tally = None


def count_replay(tally: LaunchTally) -> None:
    """Count one replay of a captured graph: each of its kernels launched
    as many times, in as many column slices, as the capture recorded."""
    for name, calls in tally.items():
        KERNELS[name].launches += calls
        KERNELS[name].columns += tally.columns[name]


def launch_device(*tensors) -> torch.device:
    """The one CUDA device of a launch's tensors (None entries skipped).
    Raises ``ValueError`` when they sit on two devices, or on none that is
    CUDA: a kernel reads its pointers on the device it runs on."""
    index = None
    for t in tensors:
        if t is None:
            continue
        i = t.get_device()  # −1 on the CPU; makes no device object
        if index is None:
            index = i
        elif i != index:
            raise ValueError("a kernel launch takes tensors on one device, not on "
                             f"{_name(index)} and {_name(i)}")
    if index is None or index < 0:
        raise ValueError("a kernel launch takes CUDA tensors, not "
                         f"{'none' if index is None else 'CPU ones'}")
    return torch.device("cuda", index)


def _name(index: int) -> str:
    return "cpu" if index < 0 else f"cuda:{index}"


def call_on_device(device: torch.device, fn, *args):
    """``fn(*args)`` with ``device`` current: the runtime launches on
    ``cudaGetDevice()``'s device whatever the pointers. The current device
    is switched only when it is another."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def current_stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream

