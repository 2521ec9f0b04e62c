"""The native (C++) block-manager core: ctypes bindings and a lazy build.

The port's copy of ``atoma_infer_tpu/native/__init__.py``. It binds the
repository's host-side core, ``csrc/atoma_core.cpp`` at the repository root
(the block manager's state machine, prefix caching's hashed allocation and
LRU eviction, and the slot-mapping fill), which neither package owns. The
library is built on first use with the ``csrc/Makefile`` recipe (``g++ -O3
-std=c++17 -fPIC -shared``) into the port's own ignored build directory,
``atoma_infer_tpu_torch/csrc/build/``, and rebuilt when the source is newer
than it. Several processes may build at once (test workers, tensor- and
pipeline-parallel ranks): each compiles to a name of its own and moves the
result into place with ``os.replace``, so a process never loads a library
another is still writing.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "atoma_core.cpp"
LIB_PATH = Path(__file__).resolve().parents[1] / "csrc" / "build" / "libatoma_core.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64p = c.POINTER(c.c_int64)
    i32p = c.POINTER(c.c_int32)
    lib.abm_create.restype = c.c_void_p
    lib.abm_create.argtypes = [c.c_int, c.c_int, c.c_int, c.c_double, c.c_int]
    lib.abm_destroy.argtypes = [c.c_void_p]
    lib.abm_can_allocate.restype = c.c_int
    lib.abm_can_allocate.argtypes = [c.c_void_p, c.c_int]
    lib.abm_allocate.restype = c.c_int
    lib.abm_allocate.argtypes = [c.c_void_p, i64p, c.c_int, c.c_int]
    lib.abm_can_append_slots.restype = c.c_int
    lib.abm_can_append_slots.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.abm_append_slot.restype = c.c_int
    lib.abm_append_slot.argtypes = [c.c_void_p, c.c_int64, c.c_int, i32p]
    lib.abm_fork.restype = c.c_int
    lib.abm_fork.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.abm_last_block_shared.restype = c.c_int
    lib.abm_last_block_shared.argtypes = [c.c_void_p, c.c_int64]
    lib.abm_can_swap_in.restype = c.c_int
    lib.abm_can_swap_in.argtypes = [c.c_void_p, i64p, c.c_int, c.c_int]
    lib.abm_swap_in.restype = c.c_int
    lib.abm_swap_in.argtypes = [c.c_void_p, i64p, c.c_int, i32p]
    lib.abm_can_swap_out.restype = c.c_int
    lib.abm_can_swap_out.argtypes = [c.c_void_p, i64p, c.c_int]
    lib.abm_swap_out.restype = c.c_int
    lib.abm_swap_out.argtypes = [c.c_void_p, i64p, c.c_int, i32p]
    lib.abm_free_seq.argtypes = [c.c_void_p, c.c_int64]
    lib.abm_reset.argtypes = [c.c_void_p]
    lib.abm_has_table.restype = c.c_int
    lib.abm_has_table.argtypes = [c.c_void_p, c.c_int64]
    lib.abm_get_table.restype = c.c_int
    lib.abm_get_table.argtypes = [c.c_void_p, c.c_int64, i32p, c.c_int]
    lib.abm_num_free_device.restype = c.c_int
    lib.abm_num_free_device.argtypes = [c.c_void_p]
    lib.abm_num_free_host.restype = c.c_int
    lib.abm_num_free_host.argtypes = [c.c_void_p]
    lib.fill_slot_mapping.argtypes = [
        i32p, c.c_int, c.c_int, c.c_int, c.c_int, i32p,
    ]
    # Prefix caching (content-hash allocation + computed tracking + LRU).
    lib.abm_enable_prefix_caching.argtypes = [c.c_void_p, c.c_int]
    lib.abm_allocate_cached.restype = c.c_int
    lib.abm_allocate_cached.argtypes = [
        c.c_void_p, i64p, c.c_int, c.c_int, i64p, c.c_int,
    ]
    lib.abm_mark_computed.argtypes = [c.c_void_p, c.c_int64, c.c_int]
    lib.abm_computed_prefix.restype = c.c_int
    lib.abm_computed_prefix.argtypes = [c.c_void_p, c.c_int64, i32p, c.c_int]
    lib.abm_touch.argtypes = [c.c_void_p, c.c_int64, c.c_double]
    return lib


def build() -> Path:
    """Compile ``csrc/atoma_core.cpp`` into ``LIB_PATH`` (to a name of this
    process's first, then moved into place). Raises when it cannot."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"native core source {SOURCE} is missing")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) to build the native core")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    return LIB_PATH


def _stale() -> bool:
    return not LIB_PATH.exists() or (
        SOURCE.exists() and SOURCE.stat().st_mtime > LIB_PATH.stat().st_mtime)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native core; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            try:
                build()
            except Exception as e:  # toolchain-specific
                logger.warning("native core build failed: %s", e)
                return None
        try:
            _lib = _declare(ctypes.CDLL(str(LIB_PATH)))
        except OSError as e:
            logger.warning("native core load failed: %s", e)
            return None
        return _lib


def available() -> bool:
    return load() is not None
