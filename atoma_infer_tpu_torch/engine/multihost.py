"""The lockstep of tensor parallelism across processes.

Counterpart of ``atoma_infer_tpu/engine/multihost.py``. The scheduler is
REPLICATED, not sharded: rank 0 is the only frontend; at every engine step
it broadcasts the admission delta (serialized request groups and aborts) to
every rank, and every rank runs the identical deterministic scheduler over
the identical request stream, then runs the same step on its shard of the
weights and the KV cache. No other scheduler traffic exists.

Rank 0: ``attach_primary(service)`` hooks the engine so each ``step()``
first broadcasts that step's admissions; run the service normally, then
``shutdown(service)`` releases the followers (``LlmService.stop`` does both
for a service it started with ``tensor_parallel_size > 1``).

Ranks 1..N-1: ``follower_loop(service)`` blocks on the broadcast, mirrors
admissions and aborts into the local (identical) scheduler, and steps the
engine in lockstep. Sampling noise is seeded per sequence and step, and the
logits are gathered whole on every rank, so every rank samples the same
tokens.
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue
import threading
from typing import Any, Dict, List

from ..parallel.distributed import broadcast_step_payload
from ..sampling_params import NextTokenChooserParameters, StoppingCriteriaParameters
from ..sequence import Sequence, SequenceGroup


def serialize_group(group: SequenceGroup) -> Dict[str, Any]:
    first = group.get_first_seq()
    return {
        "rid": group.request_id,
        "prompt": first.prompt,
        "ids": list(first.sequence_data.prompt_token_ids),
        "seq_ids": sorted(group.sequences),
        "eos": first.eos_token_id,
        "params": dataclasses.asdict(group.next_token_chooser_params),
        "stopping": dataclasses.asdict(group.stopping_criteria),
        "logprobs": group.logprobs,
        "best_of": getattr(group, "best_of", 1),
        "top_n": getattr(group, "top_n_tokens", 0),
        "num_return": getattr(group, "num_return", 1),
        # The pipeline cohort rank 0 assigned: every rank schedules the
        # group in the same cohort.
        "cohort": getattr(group, "cohort", 0),
    }


def deserialize_group(d: Dict[str, Any], block_size: int) -> SequenceGroup:
    sequences = [
        Sequence(
            seq_id=sid,
            prompt=d["prompt"],
            prompt_token_ids=list(d["ids"]),
            block_size=block_size,
            eos_token_id=d["eos"],
        )
        for sid in d["seq_ids"]
    ]
    group = SequenceGroup(
        request_id=d["rid"],
        sequences=sequences,
        next_token_chooser_params=NextTokenChooserParameters(**d["params"]),
        stopping_criteria=StoppingCriteriaParameters(**d["stopping"]),
        logprobs=d["logprobs"],
        best_of=d["best_of"],
        top_n_tokens=d["top_n"],
    )
    group.num_return = d["num_return"]
    group.cohort = d.get("cohort", 0)
    return group


class PrimarySync:
    """Installed on rank 0's engine: ``pre_step`` (called by ``LlmEngine``
    at the top of every ``step()``) is the SINGLE admission and abort
    point. It drains the pending requests, broadcasts the delta and applies
    it locally, atomically from the scheduler's point of view, so that no
    request reaches the followers' schedulers a step before rank 0's."""

    def __init__(self, engine, group):
        self.engine = engine
        self.group = group
        # The step's broadcast and the stop broadcast never interleave:
        # ``stop()`` may run on the event loop's thread while a step runs
        # on the executor's.
        self._lock = threading.Lock()
        self.stopped = False

    def pre_step(self) -> None:
        with self._lock:
            if self.stopped:
                raise RuntimeError("lockstep: the followers were released; no step can run")
            self._pre_step()

    def _pre_step(self) -> None:
        engine = self.engine
        # Requests parked by the run loop's idle path, then anything queued
        # since (add_request only enqueues; with pre_step installed the run
        # loop never admits directly — LlmEngine.run).
        admits = list(engine._admit_backlog)
        engine._admit_backlog.clear()
        while True:
            try:
                group = engine._new_requests.get_nowait()
            except asyncio.QueueEmpty:
                break
            if group is None:  # shutdown sentinel: leave it for the run loop
                engine._new_requests.put_nowait(None)
                break
            admits.append(group)
        aborts: List[str] = []
        while True:
            try:
                aborts.append(engine._pending_aborts.get_nowait())
            except queue.Empty:
                break
        payload = {"admit": [serialize_group(g) for g in admits], "aborts": aborts,
                   "stop": False}
        broadcast_step_payload(self.group, payload)
        for group in admits:
            engine._scheduler_for(group).add_sequence_group(group)
        # step()'s _drain_aborts consumes exactly this snapshot; aborts
        # arriving after this point wait for the next step's broadcast.
        engine._abort_snapshot.extend(aborts)


def attach_primary(service) -> PrimarySync:
    sync = PrimarySync(service.engine, service.group)
    service.engine.pre_step = sync.pre_step
    return sync


def shutdown(service) -> None:
    """Rank 0: release the followers after the engine drains (no step
    broadcasts after this one)."""
    sync = service.lockstep
    with sync._lock:
        sync.stopped = True
        broadcast_step_payload(service.group, {"admit": [], "aborts": [], "stop": True})


def follower_loop(service):
    """Ranks 1..N-1: mirror rank 0's request stream and step in lockstep.
    Returns the finished outputs (identical to rank 0's, by construction)
    when rank 0 broadcasts the stop flag."""
    engine = service.engine
    finished = []
    while True:
        payload = broadcast_step_payload(service.group, None)
        for d in payload["admit"]:
            group = deserialize_group(d, service.block_size)
            engine._groups[group.request_id] = group
            engine._scheduler_for(group).add_sequence_group(group)
        for rid in payload["aborts"]:
            engine._pending_aborts.put(rid)
        if payload["stop"]:
            return finished
        finished.extend(engine.step())
