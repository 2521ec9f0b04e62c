"""Debug tensor printing (ref: help/src/lib.rs:5-89 ``print_tensor!``).

The port's copy of ``atoma_infer_tpu/utils/debug.py`` for torch tensors: the
reference reads CUDA device pointers to pretty-print tensors; here the
tensor is copied to the host first (a synchronizing read on the card).
The JAX module's ``traced_print`` (a host callback from jitted code) has no
counterpart: PyTorch runs eagerly, so ``print_tensor`` serves there too.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A torch tensor (any device or dtype) or array-like as a numpy array;
    dtypes numpy lacks (bf16, e4m3) are widened to f32, exactly."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            t = t.float()
        return t.numpy()
    return np.asarray(x)


def print_tensor(name: str, x, max_elems: int = 64) -> None:
    """Print shape/dtype/stats + leading values of a torch tensor or array."""
    arr = _host(x)
    flat = arr.reshape(-1)
    head = np.array2string(flat[:max_elems], precision=4, separator=", ")
    dtype = x.dtype if isinstance(x, torch.Tensor) else arr.dtype
    print(
        f"{name}: shape={tuple(arr.shape)} dtype={dtype} "
        f"min={flat.min():.4g} max={flat.max():.4g} "
        f"mean={flat.astype(np.float64).mean():.4g}\n  {head}"
        + (" ..." if flat.size > max_elems else "")
    )


def print_tensor_no_data(name: str, x) -> None:
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    print(f"{name}: shape={shape} dtype={x.dtype if hasattr(x, 'dtype') else np.asarray(x).dtype}")
