"""The lockstep broadcast: step payloads from rank 0 to every rank.

Counterpart of ``atoma_infer_tpu/parallel/distributed.py``. The scheduler is
REPLICATED, not sharded: rank 0 runs the only frontend and, at every engine
step, broadcasts that step's admitted requests and aborts; every rank runs
the identical deterministic scheduler over the identical request stream and
feeds its own shard of the same step (``engine/multihost.py``).

In JAX the ranks are hosts that join one ``jax.distributed`` runtime and a
host's process drives all its chips; here every rank is a process of its own
(one card each, or several sharing a card), so tensor parallelism within a
host and across hosts are the same code with other rank layouts:
:func:`init_distributed` joins the ranks through
``torch.distributed``'s rendezvous at ``coordinator_address``.

Payloads keep the JAX package's format byte for byte: JSON, zlib level 1,
an int64 length prefix, padded to the first of four size buckets that holds
it (1 KiB, 16 KiB, 256 KiB, 4 MiB). The steady-decode payload (no
admission, no abort) fits the smallest bucket, so the common step costs ONE
broadcast; a larger one sends a first-bucket header holding the negated
bucket size, then the full bucket.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Optional

import numpy as np

from .group import TpGroup, choose_backend, device_share

_BUCKETS = (1 << 10, 1 << 14, 1 << 18, 1 << 22)


def rendezvous(coordinator_address: str) -> str:
    """``coordinator_address`` as a rendezvous: ``host:port`` (the JAX
    package's form) becomes ``tcp://host:port``; ``file://`` and ``tcp://``
    addresses pass as they are."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def init_distributed(coordinator_address: str, num_processes: int, process_id: int, *,
                     device, local_ranks: int, local_devices: int, watch=None) -> TpGroup:
    """Join the ranks' runtime as ``process_id`` of ``num_processes`` (JAX
    ``init_distributed``) and return this rank's :class:`TpGroup` on
    ``device``; the backend comes from the layout of one host's
    ``local_ranks`` ranks over its ``local_devices`` cards
    (``group.choose_backend``). ``watch`` (rank 0) raises when a rank it
    started has died while it waits for the others to join."""
    backend, shared = choose_backend(device.type, local_ranks, local_devices)
    share = device_share(device.type, process_id % local_ranks, local_ranks, local_devices)
    return TpGroup.join(tp=num_processes, rank=process_id, device=device,
                        init_method=rendezvous(coordinator_address), backend=backend,
                        stage_on_host=shared, device_share=share, watch=watch)


def encode_payload(obj: Any) -> np.ndarray:
    """Python object → length-prefixed uint8 array padded to a size bucket
    (zlib level 1: prompt token ids compress 3-5×, often the difference
    between the one-broadcast small bucket and a two-phase big one)."""
    raw = zlib.compress(json.dumps(obj, separators=(",", ":")).encode("utf-8"), 1)
    size = len(raw)
    for b in _BUCKETS:
        if size + 8 <= b:
            buf = np.zeros((b,), np.uint8)
            buf[:8] = np.frombuffer(np.int64(size).tobytes(), np.uint8)
            buf[8: 8 + size] = np.frombuffer(raw, np.uint8)
            return buf
    raise ValueError(f"step payload too large: {size} bytes")


def decode_payload(buf: np.ndarray) -> Any:
    size = int(np.frombuffer(bytes(buf[:8]), np.int64)[0])
    return json.loads(zlib.decompress(bytes(buf[8: 8 + size])).decode("utf-8"))


def broadcast_step_payload(group: Optional[TpGroup], obj: Any = None) -> Any:
    """Rank 0's ``obj`` → every rank (rank 0 passes the value, the others
    None). One rank: a passthrough. The small bucket is one broadcast; a
    larger payload sends the negated bucket size in a first-bucket header,
    then the bucket (JAX ``broadcast_step_payload``, ``:95-158``)."""
    if group is None or group.tp == 1:
        return obj
    b0 = _BUCKETS[0]
    buf = first = None
    if group.is_primary:
        buf = encode_payload(obj)
        if len(buf) <= b0:
            first = buf
        else:
            first = np.zeros((b0,), np.uint8)
            first[:8] = np.frombuffer(np.int64(-len(buf)).tobytes(), np.uint8)
    out = group.broadcast_bytes(first, b0)
    size = int(np.frombuffer(bytes(out[:8]), np.int64)[0])
    if size >= 0:
        return decode_payload(out)
    return decode_payload(group.broadcast_bytes(buf, -size))
