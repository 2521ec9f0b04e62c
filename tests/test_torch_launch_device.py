"""Every kernel launch runs on its tensors' device.

The runtime launches a kernel on ``cudaGetDevice()``'s device whatever its
pointers, so a pipeline stage on ``cuda:1`` must launch with ``cuda:1``
current. Each launch wrapper takes the device from the tensors it passes
(``ops/cuda_lib.py`` ``launch_device``), refuses tensors on two devices, and
``CudaKernel`` launches with that device current. The kernels cannot run
here, so the tensors are CPU tensors that report a CUDA device (a tensor
subclass, with factory calls for a CUDA device made on the CPU under a
function mode), ``torch.cuda.device`` is a recorder, and each kernel's C
entry point is a stub that notes the device current when it is called.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from atoma_infer_tpu_torch.ops import cuda_lib
from atoma_infer_tpu_torch.ops import kv_write as kw
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops import quant_kernels as qk
from atoma_infer_tpu_torch.ops.attention import AttentionMetadata
from atoma_infer_tpu_torch.tools import w8a8_probe

_CLASSES = {}


def _card_class(index: int):
    """A tensor subclass whose tensors say they sit on ``cuda:index``."""
    if index not in _CLASSES:
        def device(self):
            return torch.device("cuda", index)

        @classmethod
        def torch_function(cls, func, types, args=(), kwargs=None):
            with torch._C.DisableTorchFunctionSubclass():
                out = func(*args, **(kwargs or {}))
            return out.as_subclass(cls) if isinstance(out, torch.Tensor) else out

        _CLASSES[index] = type(f"OnCuda{index}", (torch.Tensor,), {
            "device": property(device), "is_cuda": property(lambda self: True),
            "get_device": lambda self: index, "__torch_function__": torch_function})
    return _CLASSES[index]


def on(t: torch.Tensor, index: int) -> torch.Tensor:
    return t.contiguous().as_subclass(_card_class(index))


class _FactoriesOnCpu(TorchFunctionMode):
    """Tensors made for a CUDA device are made on the CPU and report it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        device = kwargs.get("device")
        if device is not None and torch.device(device).type == "cuda":
            kwargs["device"] = "cpu"
            return on(func(*args, **kwargs), torch.device(device).index or 0)
        return func(*args, **kwargs)


@pytest.fixture
def launches(monkeypatch):
    """(kernel name, current device) of every launch; the occupancy queries
    answer as an H100 would."""
    current = [torch.device("cuda", 0)]
    seen = []

    @contextlib.contextmanager
    def device(d):
        before, current[0] = current[0], torch.device(d)
        try:
            yield
        finally:
            current[0] = before

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0].index)
    monkeypatch.setattr(cuda_lib, "current_stream_handle", lambda d: 0)
    for name, kernel in cuda_lib.KERNELS.items():
        monkeypatch.setattr(kernel, "_fn",
                            lambda *args, name=name: seen.append((name, current[0])) or 0)
        monkeypatch.setattr(kernel, "launches", kernel.launches)  # restored after the test
    for fn in ("_rpa_slots", "_fused_slots"):
        monkeypatch.setattr(pa, fn, lambda *a: 2 * 132)
    monkeypatch.setattr(qk, "_mma_slots", lambda *a: 2 * 132)
    monkeypatch.setattr(qk, "_w8a8_mma_slots", lambda *a: 2 * 132)
    with _FactoriesOnCpu():
        yield seen


def _attention_inputs(dtype, kind=None, decode=True):
    rng = np.random.default_rng(0)
    S, P, bs, Hq, Hk, D = 2, 2, 16, 4, 2, 64
    T = S if decode else 6
    cache_dtype = dtype if kind is None else kind
    q = torch.from_numpy(rng.standard_normal((T, Hq, D)).astype(np.float32)).to(dtype)
    kv = torch.from_numpy(rng.standard_normal((T, Hk, D)).astype(np.float32)).to(dtype)
    cache = torch.zeros((S * P, bs, 2 * Hk * D), dtype=cache_dtype)
    scales = torch.ones((S * P, bs, 2), dtype=torch.bfloat16) if kind == torch.int8 else None
    qsl = torch.tensor([0, 1, 2] if decode else [0, 3, 6], dtype=torch.int32)
    meta = dict(slot_mapping=torch.arange(T, dtype=torch.int32),
                block_tables=torch.arange(S * P, dtype=torch.int32).reshape(S, P),
                seq_lens=torch.tensor([1, 1] if decode else [3, 3], dtype=torch.int32),
                query_start_loc=qsl, num_seqs=torch.tensor([S], dtype=torch.int32))
    return dict(q=q, k=kv, v=kv.clone(), cache=cache, scales=scales, meta=meta,
                decode_only=decode, max_q_len=1 if decode else 3)


def _place(inputs, index, odd=None, odd_index=0):
    """``inputs`` on ``cuda:index``, the one named ``odd`` on ``odd_index``."""
    def put(name, t):
        return None if t is None else on(t, odd_index if name == odd else index)

    meta = AttentionMetadata(**{k: put(k, v) for k, v in inputs["meta"].items()},
                             block_size=16, decode_only=inputs["decode_only"],
                             max_q_len=inputs["max_q_len"])
    return {k: (meta if k == "meta" else put(k, v)) for k, v in inputs.items()
            if k not in ("decode_only", "max_q_len")}


def _ragged(x):
    return pa.ragged_paged_attention_cuda(x["q"], x["cache"], x["meta"], scale=0.125,
                                          kv_scales=x["scales"])


def _fused(x):
    return pa.ragged_paged_attention_fused_cuda(x["q"], x["cache"], x["k"], x["v"], x["meta"],
                                                scale=0.125, kv_scales=x["scales"])


def _split_launch(x, splits):
    out = torch.empty_like(x["q"])
    return pa.fused_split_launch(x["q"], x["cache"], x["k"], x["v"], x["meta"], splits, out,
                                 kind=None, scale=0.125)


def _mma_launch(x, splits):
    out = torch.empty_like(x["q"])
    return pa.ragged_paged_attention_mma_launch(x["q"], x["cache"], x["meta"],
                                                pa.RpaPlan(4, 16, splits), out, kind=None,
                                                scale=0.125)


ATTENTION = {
    # name: (q dtype, cache kind, decode step, call, the tensor put elsewhere, kernels)
    "ragged-f32": (torch.float32, None, False, _ragged, "cache",
                   ["ragged_paged_attention"]),
    "ragged-bf16-mma": (torch.bfloat16, None, False, _ragged, "cache",
                        ["ragged_paged_attention_mma"]),
    "ragged-int8-mma": (torch.bfloat16, torch.int8, False, _ragged, "scales",
                        ["ragged_paged_attention_int8_mma"]),
    "fused-f32": (torch.float32, None, True, _fused, "k", ["fused_decode_attention"]),
    "fused-bf16-split": (torch.bfloat16, None, True, _fused, "slot_mapping",
                         ["fused_decode_attention_split"]),
    "fused-split-merge": (torch.bfloat16, None, True, lambda x: _split_launch(x, 2), "v",
                          ["fused_decode_attention_split", "paged_attention_split_combine"]),
    "mma-split-merge": (torch.bfloat16, None, False, lambda x: _mma_launch(x, 2), "q",
                        ["ragged_paged_attention_mma", "paged_attention_split_combine"]),
}


@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_attention_launches_on_its_tensors_device(name, launches):
    dtype, kind, decode, call, odd, kernels = ATTENTION[name]
    inputs = _attention_inputs(dtype, kind, decode)
    call(_place(inputs, 1))
    assert launches == [(k, torch.device("cuda", 1)) for k in kernels]
    launches.clear()
    with pytest.raises(ValueError):
        call(_place(inputs, 1, odd=odd))
    assert launches == []


def test_merge_launches_on_its_tensors_device(launches):
    """The merge of split rows on its own: its workspaces, output and
    metadata on one device."""
    inputs = _attention_inputs(torch.bfloat16)
    T, Hq, D = inputs["q"].shape
    inputs.update(ws_o=torch.zeros((2, T, Hq, D)), ws_ml=torch.zeros((2, T, Hq, 2)))

    def call(x):
        pa.split_combine(x["ws_o"], x["ws_ml"], x["q"], x["meta"], num_kv_heads=2, bq=1,
                         splits=2, min_tiles=pa.FUSED_MIN_TILES)

    call(_place(inputs, 1))
    assert launches == [("paged_attention_split_combine", torch.device("cuda", 1))]
    launches.clear()
    with pytest.raises(ValueError):
        call(_place(inputs, 1, odd="seq_lens"))
    assert launches == []


def _writes(kind):
    rng = np.random.default_rng(1)
    T, Hk, D = 3, 2, 64
    kv = torch.from_numpy(rng.standard_normal((T, Hk, D)).astype(np.float32))
    cache = torch.zeros((4, 16, 2 * Hk * D), dtype=kind)
    return dict(cache=cache, k=kv, v=kv.clone(), slots=torch.arange(T, dtype=torch.int32),
                scales=torch.ones((4, 16, 2), dtype=torch.bfloat16))


WRITES = {
    "f32": (torch.float32, "reshape_and_cache"),
    "fp8": (torch.float8_e4m3fn, "reshape_and_cache_fp8"),
    "int8": (torch.int8, "reshape_and_cache_int8"),
}


@pytest.mark.parametrize("name", sorted(WRITES))
def test_kv_writes_launch_on_their_tensors_device(name, launches):
    kind, kernel = WRITES[name]
    x = _writes(kind)

    def call(x):
        if kind == torch.int8:
            kw.write_kv_cache_quant_cuda(x["cache"], x["scales"], x["k"], x["v"], x["slots"])
        else:
            kw.write_kv_cache_cuda(x["cache"], x["k"], x["v"], x["slots"])

    call({k: on(v, 1) for k, v in x.items()})
    assert launches == [(kernel, torch.device("cuda", 1))]
    launches.clear()
    odd = "scales" if kind == torch.int8 else "slots"
    with pytest.raises(ValueError):
        call({k: on(v, 0 if k == odd else 1) for k, v in x.items()})
    assert launches == []


MATMULS = {
    # name: (activation dtype, bits, W8A8, kernel)
    "int8-cuda-cores": (torch.float32, 8, False, "quantized_matmul_int8"),
    "int8-mma": (torch.bfloat16, 8, False, "quantized_matmul_int8_mma"),
    "int4-mma": (torch.bfloat16, 4, False, "quantized_matmul_int4_mma"),
    "w8a8-mma": (torch.bfloat16, 8, True, "quantized_matmul_w8a8_mma"),
}


@pytest.mark.parametrize("name", sorted(MATMULS))
def test_quantized_matmuls_launch_on_their_tensors_device(name, launches):
    from atoma_infer_tpu_torch.ops.quant import quantize_weight

    dtype, bits, w8a8, kernel = MATMULS[name]
    g = torch.Generator().manual_seed(2)
    w = quantize_weight(torch.randn(256, 128, generator=g), bits=bits, group_size=64)
    x = torch.randn(8, 256, generator=g).to(dtype)
    xq, act = qk.quantize_activations(x)

    def call(index, odd=None):
        args = dict(x=x, xq=xq, act=act, q=w.qweight, s=w.scales)
        a = {k: on(v, 0 if k == odd else index) for k, v in args.items()}
        if w8a8:
            return qk.w8a8_matmul_cuda(a["xq"], a["q"], a["s"], a["act"], bits=bits,
                                       group_size=64, out_dtype=dtype)
        return qk.quantized_matmul_cuda(a["x"], a["q"], a["s"], bits=bits, group_size=64)

    call(1)
    assert launches == [(kernel, torch.device("cuda", 1))]
    launches.clear()
    with pytest.raises(ValueError):
        call(1, odd="s")
    assert launches == []


def test_probe_launches_on_its_tensors_device(launches):
    x = on(torch.zeros((8, 64), dtype=torch.int8), 1)
    w = torch.zeros((64, 128), dtype=torch.int8)
    w8a8_probe.probe_matmul_cuda(x, on(w, 1))
    assert launches == [("probe_matmul_int8", torch.device("cuda", 1))]
    launches.clear()
    with pytest.raises(ValueError):
        w8a8_probe.probe_matmul_cuda(x, on(w, 0))
    assert launches == []


def test_launch_device_takes_one_cuda_device():
    a, b = on(torch.zeros(2), 1), on(torch.zeros(3), 1)
    assert cuda_lib.launch_device(a, None, b) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one device"):
        cuda_lib.launch_device(a, on(torch.zeros(2), 0))
    with pytest.raises(ValueError, match="not CPU ones"):
        cuda_lib.launch_device(torch.zeros(2))
    with pytest.raises(ValueError, match="not none"):
        cuda_lib.launch_device(None)


def test_a_kernel_launches_only_with_a_device(monkeypatch):
    """``CudaKernel`` takes its device as a keyword it cannot do without,
    and makes it current around the C call when another is current."""
    kernel = cuda_lib.KERNELS["reshape_and_cache"]
    current, calls, switches = [torch.device("cuda", 0)], [], []

    @contextlib.contextmanager
    def device(d):
        switches.append(torch.device(d))
        before, current[0] = current[0], torch.device(d)
        yield
        current[0] = before

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0].index)
    monkeypatch.setattr(kernel, "_fn", lambda *a: calls.append(current[0]) or 0)
    monkeypatch.setattr(kernel, "launches", kernel.launches)  # restored after the test
    launched = kernel.launches
    with pytest.raises(TypeError):
        kernel(1, 2, 3)
    kernel(1, 2, 3, device=torch.device("cuda", 3))
    kernel(1, 2, 3, device=torch.device("cuda", 0))
    assert calls == [torch.device("cuda", 3), torch.device("cuda", 0)]
    assert switches == [torch.device("cuda", 3)] and current[0] == torch.device("cuda", 0)
    assert kernel.launches == launched + 2
