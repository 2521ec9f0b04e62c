"""Every step captured in a CUDA graph and replayed: a single-stage
worker's, each pipeline stage's, and a tensor-parallel rank's in segments
between its collectives.

The port's counterpart of the JAX worker's one compiled program per bucket
(``atoma_infer_tpu/engine/worker.py:207-222``), of the pipelined worker's
one jitted program a stage (``atoma_infer_tpu/engine/pp_worker.py:90-187``)
and of the one SPMD program a tensor-parallel step is there, whose psums XLA
inserts. An eager step launches a few hundred kernels from Python; a replay
launches them all with one call. On a CUDA worker every step replays a graph
of its key: pure-decode, verify, prefill, mixed prefill + decode and
penalty steps; under pipeline parallelism each stage replays a graph of its
own, from a ``StepGraphs`` of its own on its device. CPU workers step
eagerly.

The graph key is the JAX step's static arguments, ``(T, S, P, decode_only,
needs_sampling, needs_penalties, needs_typical, top_n, spec, feed)``, and
``max_q_len``, which sizes the ragged kernels' grid and plan. Two kinds
keep their shorter keys, so that their graphs are those measured before
the other steps had any: a pure-decode step without penalties,
:class:`DecodeKey` ``(T, S, P, needs_sampling, needs_typical, top_n,
feed)``, and a verify step (decode and drafted rows, no penalties),
:class:`VerifyKey` ``(T, S, P, 1+K, needs_sampling, needs_typical, top_n,
True)``, T being S·(1+K) or a smaller power of two when the drafts fill
less than half of it; a verify step has no feed, since a step with drafts
runs synchronously. Every other step has a :class:`StepKey`: its
``max_q_len`` is 1 (penalty decode), 1+K (penalty verify) or the bucket of
its longest prefill chunk (``input_prep``), and ``spec`` is the verify
rows' width 1+K, or 0.
Everything else a step reads is the same tensors (weights, the KV caches,
updated in place) or is copied into the static inputs before each replay,
on the stream the replay runs on:
- the packed metadata (token ids, positions, slots, block tables, lengths,
  the selected or verify rows, the feed's ``prev_map``);
- the sampling tensors, when the worker's sampling version changed (every
  step of a penalty batch, whose recent-token window moves);
- the Gumbel noise ``[S, V]``, made eagerly (a ``torch.Generator`` per row,
  reseeded from host integers, cannot be captured);
- the async feed's previous tokens.

The static inputs are ONE set for every key, each sized for the largest
step the scheduler can make: the widest token bucket (its token budget,
``max_num_batched_tokens``, or S·(1+K) on a verify step), the largest
sequence and page buckets. A graph reads the leading rows of each (its S
rows, its packed length), so their memory does not grow with the number of
keys. That is safe because graphs replay one at a time on one stream: each
fill is enqueued after the previous replay's reads.

A key's first step runs eagerly, which also loads every kernel and library
handle and fills every lookup cache it needs (kernel plans, occupancy), and
the capture follows it: nothing happens for the first time inside a
capture. Later steps of the key replay. Every graph is captured into one
memory pool, so the pool holds one step's workspaces whatever the number of
keys (the widest of them: a mixed step's activations at its T, or the LM
head and sampler at the largest S); what stays allocated per key is its
outputs. A graph's outputs are read only by work enqueued before the next
replay (the host copy of the step's tokens, the next step's feed copy), so
the next graph may reuse their memory, whatever its kind. Each instantiated
graph also holds device memory outside PyTorch's allocator, 2–3 MiB at 16–32 layers
(measured on an H100 by ``chip_smoke.py``), and the keys a deployment can
reach number in the thousands (token, sequence and page buckets ×
``max_q_len`` buckets × sampling flags × top-n × feed): at most
``MAX_GRAPHS`` graphs live, and capturing one more drops the least recently
used, whose key is captured again at its next step. A capture or replay
that fails raises; nothing falls back to the eager step.

A tensor-parallel rank (``StepGraphs(group=…)``, its model's ``TpGroup`` at
tp > 1) captures a key as an ordered list of segments, the graphs between
its collectives: ``graph_0, collective_0, graph_1, …, graph_n`` — 3·L + 2
graphs a step over an INT8 cache (the layer's two row-parallel sums and its
scales' max, then the logits' gather), 2·L + 2 otherwise. While the step is
captured, ``TpGroup.segmented`` hands each collective to the capture: it
ends the running graph, records the operation and the tensor it works on,
and begins the next graph on the same capture stream and in the same pool
(the gather with a static output ``[…, tp·n]`` allocated in that next
graph, which reads it). A capture issues no collective and counts none;
every rank captures the same key at the same step, after the key's eager
first step (whose collectives are real), because the keys come from the
lockstep's replicated schedule. A replay runs the segments in order on the
current stream and the real collective after each but the last: in place
for the two all-reduces, into the static output for the gather; it counts
every segment's kernel launches and exactly the eager step's collectives.
The tensors a collective works on are the pool's, like any workspace of a
graph, and no key keeps them: a segment holds a view that does not own its
memory (the graphs' replays in capture order write and read it, as they do
every other workspace), so a key costs its outputs and what its
instantiated segments hold outside PyTorch's allocator, as at tp 1. A
collective between two replays is gloo through pinned host memory when
ranks share a card (it cannot be captured), NCCL on the rank's current
stream with a card a rank: that route has not been run yet (ROADMAP.md,
items 13 and 19).

A pipeline stage (``engine/pp_worker.py``) keys its graphs so:
- the last stage, which runs its layers, the LM head and the sampler, by
  :func:`step_graph_key`, as a single-stage step (there is no feed under
  PP);
- a stage before it by :class:`StageKey` ``(T, S, P, decode_only,
  max_q_len)``, the static arguments of its forward alone: like JAX's
  non-last stage programs it samples nothing, so two steps that differ only
  in their sampling flags replay one graph.
A stage after the first reads one more static input, the hidden state
``[token_capacity, H]`` in the model's dtype, filled by a ``copy_`` from
the previous stage's output (across devices when the stages are on two).
Stages that share a device share one memory pool (``pools``, one
``graph_pool_handle`` a device): every replay on a device runs on its one
current stream, whatever the stage, and each graph's outputs are held by
its ``_Graph`` and read (the next stage's fill, the host copy of the
tokens) by work enqueued before the next replay on that stream, so the
argument above holds across stages as it does across keys, and the pool
holds the widest stage's step once rather than once a stage.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch

from ..ops import cuda_lib
from .input_prep import bucket


# The most graphs a worker keeps: the KV pool leaves their memory free
# (``llm_service.graph_reserve_bytes``). Steady traffic reaches far fewer
# keys (the smoke's services 6–11 in their traffic, 29 with warmup and the
# widest keys; PERF.md).
MAX_GRAPHS = 64


class DecodeKey(NamedTuple):
    """A pure-decode step without penalties."""

    T: int
    S: int
    P: int
    needs_sampling: bool
    needs_typical: bool
    top_n: int
    feed: bool


class VerifyKey(NamedTuple):
    """A verify step: decode and drafted rows, no penalties."""

    T: int
    S: int
    P: int
    max_q_len: int
    needs_sampling: bool
    needs_typical: bool
    top_n: int
    verify: bool


class StepKey(NamedTuple):
    """Any other step: a prefill chunk, or penalties. The JAX step's static
    arguments, and ``max_q_len``."""

    T: int
    S: int
    P: int
    decode_only: bool
    needs_sampling: bool
    needs_penalties: bool
    needs_typical: bool
    top_n: int
    spec: int          # the verify rows' width 1+K, or 0
    feed: bool
    max_q_len: int


class StageKey(NamedTuple):
    """A step of a pipeline stage before the last: its forward's static
    arguments (the stage samples nothing)."""

    T: int
    S: int
    P: int
    decode_only: bool
    max_q_len: int


GraphKey = Union[DecodeKey, VerifyKey, StepKey, StageKey]


def step_graph_key(model_input, sampling, feed: bool) -> GraphKey:
    """The graph a step replays on the card: every step has one."""
    T = model_input.token_ids.shape[0]
    S, P = model_input.block_tables.shape
    spec = 0 if model_input.spec_rows is None else model_input.spec_rows.shape[1]
    if spec and feed:
        raise ValueError("a verify step runs synchronously: it takes no feed")
    if not model_input.num_prefills and not sampling.needs_penalties:
        if spec:
            return VerifyKey(T, S, P, model_input.max_q_len, sampling.needs_sampling,
                             sampling.needs_typical, sampling.top_n, True)
        return DecodeKey(T, S, P, sampling.needs_sampling, sampling.needs_typical,
                         sampling.top_n, feed)
    return StepKey(T, S, P, model_input.decode_only, sampling.needs_sampling,
                   sampling.needs_penalties, sampling.needs_typical, sampling.top_n, spec,
                   feed, model_input.max_q_len)


def stage_graph_key(model_input, sampling, *, last: bool) -> GraphKey:
    """The graph a pipeline stage's step replays on the card: the last
    stage's is the single-stage step's key (no feed under PP), any other
    stage's a :class:`StageKey`."""
    if last:
        return step_graph_key(model_input, sampling, feed=False)
    T = model_input.token_ids.shape[0]
    S, P = model_input.block_tables.shape
    return StageKey(T, S, P, model_input.decode_only, model_input.max_q_len)


def page_capacity(max_model_len: int, block_size: int) -> int:
    """The widest block-table bucket a step can have: the pages of
    ``max_model_len`` tokens, and at least ``input_prep.bucket``'s smallest
    (8)."""
    return max(8, -(-max_model_len // block_size))


def token_capacity(max_num_batched_tokens: int) -> int:
    """The widest token bucket a step can have: the scheduler never
    schedules more than its budget of ``max_num_batched_tokens`` tokens
    (drafts included), and ``input_prep`` rounds up on the sparse ladder."""
    return bucket(max_num_batched_tokens)


def packed_capacity(max_rows: int, max_pages: int, max_tokens: int,
                    num_spec_tokens: int = 0) -> int:
    """The longest packed metadata of a step (``worker._invoke`` ``parts``)
    at ``max_rows`` sequences of ``max_pages`` pages and ``max_tokens``
    tokens (:func:`token_capacity`): token ids, positions, slots and
    ``prev_map`` (T rows each), the block tables, the lengths, the query
    starts (S + 1), the sampling steps, the sequence count and the selected
    rows (S, or the S·(1+K) verify rows with K = ``num_spec_tokens``)."""
    rows = max_rows * (1 + num_spec_tokens)
    return 4 * max_tokens + max_rows * max_pages + 3 * max_rows + rows + 2


def _alias(x: torch.Tensor) -> torch.Tensor:
    """A tensor over ``x``'s memory that does not keep it allocated, on the
    card: what a segment keeps of a capture's workspace (the graph pool
    holds the memory while a graph captured into it lives). On the CPU,
    where the allocator hands memory back, ``x`` itself."""
    if x.device.type != "cuda":
        return x
    return _view_of(x)


def _view_of(x: torch.Tensor) -> torch.Tensor:
    """A contiguous ``x`` over a storage that does not own its memory."""
    storage = torch._C._construct_storage_from_data_pointer(
        x.data_ptr(), x.device, x.numel() * x.element_size())
    return torch.empty(0, dtype=x.dtype, device=x.device).set_(
        storage, 0, x.shape, x.stride())


@dataclasses.dataclass
class _Segment:
    """A graph of a tensor-parallel step and the collective after it."""

    graph: object
    op: Optional[str]      # "sum", "max", "gather"; None after the last
    tensor: Optional[torch.Tensor] = None   # what the collective works on
    out: Optional[torch.Tensor] = None      # the gather's static output


@dataclasses.dataclass
class _Graph:
    graph: object          # the step's graph; a tensor-parallel step's first segment
    inputs: tuple          # (packed, sampling, noise, feed[, hidden]): static inputs' views
    outputs: tuple
    launches: cuda_lib.LaunchTally  # each kernel's launches (and column slices) in one replay
    segments: List[_Segment] = dataclasses.field(default_factory=list)  # under TP


class StepGraphs:
    """The captured step graphs of one worker or pipeline stage, by key,
    and the static inputs they share. ``pools`` maps a device to the memory
    pool its graphs are captured into: the stages of a pipeline pass one
    dict, so that stages on one device share one pool. ``group``: the
    model's tensor-parallel group, whose steps are captured in segments
    between its collectives (None: one graph a step)."""

    def __init__(self, max_rows: int, max_pages: int, max_tokens: int,
                 num_spec_tokens: int = 0, pools: Optional[dict] = None, group=None):
        # The largest sequence bucket a step can have, the largest page and
        # token buckets and the most drafts a sequence carries: every static
        # input is sized for them.
        self.max_rows = max_rows
        self.max_tokens = max_tokens
        self.packed_capacity = packed_capacity(max_rows, max_pages, max_tokens,
                                               num_spec_tokens)
        # By last use, the most recent last.
        self.graphs: "collections.OrderedDict[GraphKey, _Graph]" = collections.OrderedDict()
        self.capture_seconds = 0.0
        self.replays = 0
        self.evictions = 0
        # Device bytes the captures took, summed over them: the pool's
        # growth, what stays allocated in it (the graphs' outputs), and what
        # the driver took outside the caching allocator (the instantiated
        # graphs).
        self.captured_bytes = {"pool": 0, "held": 0, "driver": 0}
        self._static: Dict[str, torch.Tensor] = {}
        self._sampling_version = None
        self._pools = {} if pools is None else pools
        self.group = group if group is not None and group.tp > 1 else None

    @property
    def static_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._static.values())

    def run(self, key: GraphKey, step: Callable, packed, sampling, sampling_version, gumbel,
            prev_tokens, hidden=None) -> tuple:
        """One step of ``key``: ``step(packed, sampling, gumbel,
        prev_tokens)`` — ``step(…, hidden)`` for a pipeline stage after the
        first, ``hidden`` the previous stage's output — eagerly and then
        captured at the key's first use, a replay after.
        ``sampling_version`` changes whenever the worker's sampling tensors
        do: while it holds, they are not copied again."""
        entry = self.graphs.get(key)
        inputs = (packed, sampling, gumbel, prev_tokens) + (() if hidden is None else (hidden,))
        if entry is None:
            outputs = step(*inputs)
            views = self._views(*inputs)
            # The static inputs always hold the latest graph step's inputs,
            # so the newest graph replays right even before its next fill.
            self._fill(views, packed, sampling, sampling_version, gumbel, prev_tokens, hidden)
            self.graphs[key] = self._capture(step, views)
            if len(self.graphs) > MAX_GRAPHS:
                # The capture synchronized the device, so no replay of the
                # least recently used graph is in flight; its outputs live
                # on while a pending step holds them.
                self.graphs.popitem(last=False)
                self.evictions += 1
            return outputs
        self.graphs.move_to_end(key)
        self._fill(entry.inputs, packed, sampling, sampling_version, gumbel, prev_tokens, hidden)
        self._replay(entry)
        cuda_lib.count_replay(entry.launches)
        self.replays += 1
        return entry.outputs

    def _replay(self, entry: _Graph) -> None:
        """Replay ``entry`` on the current stream: its graph, or each
        segment's in order with the group's real collective after it."""
        if not entry.segments:
            entry.graph.replay()
            return
        group = self.group
        # The recorded tensors are the capture's, made in inference mode.
        with torch.inference_mode():
            for seg in entry.segments:
                seg.graph.replay()
                if seg.op == "sum":
                    group.all_reduce_sum(seg.tensor)
                elif seg.op == "max":
                    group.all_reduce_max(seg.tensor)
                elif seg.op == "gather":
                    group.all_gather_last(seg.tensor, out=seg.out)

    def _fill(self, views, packed, sampling, sampling_version, gumbel, prev_tokens,
              hidden=None) -> None:
        """Copy one step's inputs into a graph's views, device to device on
        the current stream, so each copy lands after the previous replay's
        reads. The previous tokens may be the same graph's output buffer,
        which the replay overwrites: the copy is enqueued before the replay,
        so it reads them first. The hidden state is likewise the previous
        stage's output, which that stage's next replay overwrites: its copy
        is enqueued first (across devices, PyTorch orders the copy after
        both devices' current streams' work, and their later work after
        it)."""
        static_packed, static_sampling, noise, feed = views[:4]
        static_packed.copy_(packed)
        if sampling_version != self._sampling_version:
            for name, t in sampling.items():
                static_sampling[name].copy_(t)
            self._sampling_version = sampling_version
        if noise is not None:
            noise.copy_(gumbel)
        if feed is not None:
            feed[: prev_tokens.shape[0]].copy_(prev_tokens)
        if hidden is not None:
            views[4].copy_(hidden)

    def _buffer(self, name: str, like: torch.Tensor, rows: int, device=None) -> torch.Tensor:
        """The static input ``name``: ``rows`` rows shaped like ``like``'s,
        allocated at its first use on ``device`` (default: ``like``'s);
        ``like`` must fit in its leading rows."""
        buf = self._static.get(name)
        if buf is None:
            buf = torch.zeros((rows, *like.shape[1:]), dtype=like.dtype,
                              device=like.device if device is None else device)
            self._static[name] = buf
        if like.shape[0] > buf.shape[0] or like.shape[1:] != buf.shape[1:] \
                or like.dtype != buf.dtype:
            raise ValueError(f"static input {name}: a {tuple(like.shape)} {like.dtype} step "
                             f"does not fit the {tuple(buf.shape)} {buf.dtype} buffer")
        return buf

    def _views(self, packed, sampling, gumbel, prev_tokens, hidden=None) -> tuple:
        """A graph's inputs: the leading rows of each static input; a
        stage's hidden state at its T rows of ``max_tokens``."""
        static_packed = self._buffer("packed", packed, self.packed_capacity)[: packed.shape[0]]
        static_sampling = {
            name: self._buffer(f"sampling.{name}", t, self.max_rows)[: t.shape[0]]
            for name, t in sampling.items()
        }
        noise = None
        if gumbel is not None:
            noise = self._buffer("noise", gumbel, self.max_rows)[: gumbel.shape[0]]
        # The feed is the whole buffer: prev_map's rows index the previous
        # step's tokens, whatever its bucket.
        feed = None if prev_tokens is None else self._buffer("feed", prev_tokens, self.max_rows)
        if hidden is None:
            return static_packed, static_sampling, noise, feed
        # On this stage's device, whichever device the previous stage is on.
        static_hidden = self._buffer("hidden", hidden, self.max_tokens, packed.device)
        return static_packed, static_sampling, noise, feed, static_hidden[: hidden.shape[0]]

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _graph_capture(self, graph, pool):
        """The context capturing ``graph`` into ``pool``. thread_local: the
        engine steps on an executor thread; what other threads do
        meanwhile cannot invalidate this capture."""
        return torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")

    def _capture(self, step, views) -> _Graph:
        t0 = time.monotonic()
        device = views[0].device
        pool = self._pools.get(device)
        if pool is None:
            pool = self._pools[device] = torch.cuda.graph_pool_handle()
        reserved0 = torch.cuda.memory_reserved(device)
        free0 = torch.cuda.mem_get_info(device)[0]
        start = {}

        def begun():
            # Entering the capture empties the allocator's cache: the pool's
            # growth is counted from here (allocator statistics, no CUDA
            # call inside the capture).
            start.update(reserved=torch.cuda.memory_reserved(device),
                         allocated=torch.cuda.memory_allocated(device))

        entry = self._record(step, views, pool, begun)
        reserved2 = torch.cuda.memory_reserved(device)
        self.captured_bytes["pool"] += reserved2 - start["reserved"]
        self.captured_bytes["held"] += torch.cuda.memory_allocated(device) - start["allocated"]
        self.captured_bytes["driver"] += (
            free0 - torch.cuda.mem_get_info(device)[0] - (reserved2 - reserved0)
        )
        self.capture_seconds += time.monotonic() - t0
        return entry

    def _record(self, step, views, pool, begun: Optional[Callable] = None) -> _Graph:
        """Capture ``step(*views)``: one graph, or under a group a segment
        between each two of its collectives (the module docstring).
        ``begun()`` is called once the first graph's capture has begun."""
        group = self.group
        segments: List[_Segment] = []
        running = {}

        def begin():
            graph = self._new_graph()
            ctx = self._graph_capture(graph, pool)
            ctx.__enter__()
            running.update(graph=graph, ctx=ctx)

        def end(*exc):
            running.pop("ctx").__exit__(*(exc or (None, None, None)))

        def cut(op: str, x: torch.Tensor) -> torch.Tensor:
            x = x.contiguous()   # in the running graph: the collective's operand
            end()
            seg = _Segment(running["graph"], op, _alias(x))
            segments.append(seg)
            begin()
            if op != "gather":
                return x
            out = torch.empty((*x.shape[:-1], group.tp * x.shape[-1]), dtype=x.dtype,
                              device=x.device)
            seg.out = _alias(out)
            return out

        with cuda_lib.recording_launches() as launches:
            begin()
            if begun is not None:
                begun()
            try:
                with group.segmented(cut) if group is not None else contextlib.nullcontext():
                    outputs = step(*views)
            except BaseException as e:
                # End the running capture so that the stream leaves capture
                # mode; the step's own error is the one raised.
                if "ctx" in running:
                    with contextlib.suppress(Exception):
                        end(type(e), e, e.__traceback__)
                raise
            end()
        if group is None:
            return _Graph(running["graph"], views, outputs, launches)
        segments.append(_Segment(running["graph"], None))
        return _Graph(segments[0].graph, views, outputs, launches, segments)
