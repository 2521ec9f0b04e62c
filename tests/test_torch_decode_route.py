"""Pure-decode steps past 16 q heads per kv head, on the CPU: the route a
decode step's CUDA graph captures.

On the card a pure-decode step takes the fused kernel (B, or D's and E's
fused variants) up to ``MAX_FUSED_GROUP`` q heads per kv head of the
rank, and past it the write (C, the INT8 or the e4m3 write) and then the
ragged kernel (A, D or E), as JAX serves a decode step its fused kernel
does not take (``atoma_infer_tpu/ops/attention.py`` ``_fused_supported``).
The kernels cannot run here, so, as in ``tests/test_torch_launch_device.py``,
the tensors are CPU tensors that report a CUDA device and each kernel's C
entry point is a stub; the step graph is the stub of
``tests/test_torch_cuda_graphs.py``, which replays by recomputing. What is
checked: the launches a decode key's capture records (the real wrappers'
routes and checks, run on the step's shapes), and that its replays count
them again.
"""

import collections

import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.engine.cuda_graphs import StepGraphs
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops.attention import paged_attention_layer

from test_torch_cuda_graphs import _stub_capture, _StubGraph
from test_torch_launch_device import _place, launches  # noqa: F401 (a fixture)

torch.set_num_threads(2)

S, P, BS, HK, D = 4, 4, 16, 2, 64


def _decode_inputs(group, dtype, kind):
    """A pure-decode step of S sequences over ``HK`` kv heads at ``group``
    q heads each, on the CPU."""
    rng = np.random.default_rng(group)
    hq = group * HK
    cache_dtype = dtype if kind is None else kind

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    lens = [40, 17, 1, 60]
    tables = np.arange(S * P, dtype=np.int32).reshape(S, P)
    slots = [int(tables[s, (n - 1) // BS]) * BS + (n - 1) % BS for s, n in enumerate(lens)]
    meta = dict(slot_mapping=torch.tensor(slots, dtype=torch.int32),
                block_tables=torch.from_numpy(tables), seq_lens=torch.tensor(lens,
                                                                             dtype=torch.int32),
                query_start_loc=torch.arange(S + 1, dtype=torch.int32),
                num_seqs=torch.tensor([S], dtype=torch.int32))
    scales = torch.ones((S * P, BS, 2), dtype=torch.bfloat16) if kind == torch.int8 else None
    return dict(q=randn(S, hq, D), k=randn(S, HK, D), v=randn(S, HK, D),
                cache=torch.zeros((S * P, BS, 2 * HK * D), dtype=cache_dtype), scales=scales,
                meta=meta, decode_only=True, max_q_len=1)


def _stub_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    for fn in ("memory_reserved", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda device: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (0, 0))


# (group, queries, cache kind) -> the kernels one decode step launches.
ROUTES = {
    (16, torch.bfloat16, None): {"fused_decode_attention_split": 1},
    (17, torch.bfloat16, None): {"reshape_and_cache": 1, "ragged_paged_attention_mma": 1},
    (32, torch.bfloat16, None): {"reshape_and_cache": 1, "ragged_paged_attention_mma": 1},
    (17, torch.bfloat16, torch.int8): {"reshape_and_cache_int8": 1,
                                       "ragged_paged_attention_int8_mma": 1},
    (32, torch.bfloat16, torch.float8_e4m3fn): {"reshape_and_cache_fp8": 1,
                                                "ragged_paged_attention_fp8_mma": 1},
    (17, torch.float16, None): {"reshape_and_cache_f16": 1,
                                "ragged_paged_attention_mma_f16": 1},
    (32, torch.float32, None): {"reshape_and_cache": 1, "ragged_paged_attention": 1},
    (128, torch.float32, torch.int8): {"reshape_and_cache_int8": 1,
                                       "ragged_paged_attention_int8": 1},
}


@pytest.mark.parametrize("group, dtype, kind", sorted(ROUTES, key=str),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_decode_key_captures_the_route(group, dtype, kind, launches, monkeypatch):  # noqa: F811
    """A decode key's capture records the fused kernel at 16 q heads per kv
    head and the write and the ragged kernel past it (once each: a
    one-layer step), on every cache kind and queries' dtype; two replays
    count the same launches twice, and no kernel runs eagerly after the
    capture."""
    _stub_graphs(monkeypatch)
    want = ROUTES[(group, dtype, kind)]
    assert all(name in pa.cuda_lib.KERNELS for name in want)
    assert pa.decode_route(group * HK, HK) == ("fused" if group <= pa.MAX_FUSED_GROUP
                                                else "ragged")
    x = _place(_decode_inputs(group, dtype, kind), 0)

    def step(packed, sampling, gumbel, prev):
        out = paged_attention_layer(x["q"], x["cache"], x["k"], x["v"], x["meta"],
                                    scale=D ** -0.5, kv_scales=x["scales"])
        if _StubGraph.capturing:
            _StubGraph.capturing[-1].recompute = lambda: step(packed, sampling, gumbel, prev)
        return out

    graphs = StepGraphs(max_rows=S, max_pages=P, max_tokens=S)
    packed = torch.zeros(8, dtype=torch.int32)
    key = (S, S, P, True, False, 0, False)
    before = {name: k.launches for name, k in pa.cuda_lib.KERNELS.items()}
    graphs.run(key, step, packed, {}, 1, None, None)   # eager, then captured
    # The C entry points ran twice for each kernel: the eager step and the
    # capture; only the eager step counts.
    assert collections.Counter(name for name, _ in launches) == {n: 2 * c for n, c in want.items()}
    assert graphs.graphs[key].launches == want         # what the capture recorded
    for _ in range(2):
        graphs.run(key, step, packed, {}, 1, None, None)
    counted = {name: k.launches - before[name] for name, k in pa.cuda_lib.KERNELS.items()
               if k.launches != before[name]}
    assert counted == {name: 3 * n for name, n in want.items()}   # eager + 2 replays
    assert graphs.replays == 2
