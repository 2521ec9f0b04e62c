"""Tensor-parallel process group: one rank's view of the ranks it serves with.

Counterpart of ``atoma_infer_tpu/parallel/mesh.py``. In JAX, tensor
parallelism is ONE SPMD program jitted over a device mesh in one process, and
XLA inserts the collectives. In PyTorch every card runs its own process, so
the collectives are explicit: a :class:`TpGroup` holds the rank's ``tp``,
``rank`` and ``device``, and the four collectives the model and the lockstep
engine need:

- ``all_reduce_sum``: the row-parallel outputs (``o_proj``, ``down_proj``)
  and Mixtral's expert mix, the psum XLA inserts in JAX;
- ``all_reduce_max``: the INT8 KV absmax [T, 2] over every rank's kv heads;
- ``all_gather_last``: the vocab-sharded logits, so the sampler sees [S, V]
  on every rank;
- ``broadcast_bytes``: the per-step payloads of ``parallel/distributed.py``.

The backend comes from the ranks' layout (:func:`choose_backend`), is logged,
and never falls back silently: ``nccl`` when every rank on a host owns its own
CUDA device; ``gloo`` when ranks share a card — then each CUDA tensor is
copied to pinned host memory, reduced there and copied back, explicitly (NCCL
refuses two ranks on one device, and gloo's own CUDA support is not relied
on); ``gloo`` on the CPU. Payloads always travel over a gloo group of their
own, whose timeout is long: followers wait there while the primary is idle.

The process groups are objects of the group, not PyTorch's default group, so
several groups (one service after another in a test) never share state. A
service of one rank has no group at all.

Under pipeline parallelism a rank holds every stage, each on its own device
(``parallel/pipeline.py``), and each stage's model collects over
:meth:`TpGroup.for_stage`: with NCCL a tensor process group of its own, whose
ranks' tensors sit on that stage's cards; with gloo the rank's one group,
which stages any device's tensors through host memory. The payload group
and the collectives count stay one.

A CUDA graph cannot hold a gloo collective, so a rank's step is captured in
segments (``engine/cuda_graphs.py``): while a capture runs,
:meth:`TpGroup.segmented` hands the three tensor collectives of the
capturing thread to the capture's stand-in, which ends the running graph at
each one, records it, and begins the next; nothing is reduced and nothing
is counted. A replay then runs the real collective between two segments'
replays: in place for the two all-reduces, into the static output the
capture allocated for the gather (``all_gather_last(x, out=…)``). With a
card a rank the same segments run and the collective between them is NCCL
on the rank's current stream; that route has not been run yet (ROADMAP.md,
items 13 and 19).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import logging
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# A collective of a model step waits at most this long for the other ranks.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)
# Followers wait for the primary's next step payload for at most this long:
# a server may sit idle for hours between requests.
IDLE_TIMEOUT = datetime.timedelta(days=7)
# How long rank 0 waits for every rank to join the rendezvous.
JOIN_TIMEOUT_S = 600.0


def choose_backend(device_type: str, local_ranks: int, local_devices: int) -> Tuple[str, bool]:
    """(backend, shared card) from the layout of one host's ranks:
    ``local_ranks`` ranks over ``local_devices`` CUDA devices. CPU ranks
    take gloo; ranks that each own a card take nccl; ranks that share a
    card take gloo with their tensors staged through host memory."""
    if device_type == "cpu":
        return "gloo", False
    if local_devices >= local_ranks:
        return "nccl", False
    return "gloo", True


def device_share(device_type: str, local_rank: int, local_ranks: int,
                 local_devices: int) -> Tuple[int, int]:
    """(place, count): the host's ``local_rank``-th rank is the place-th of
    the count ranks on its card (:func:`local_device`); (0, 1) on the CPU."""
    if device_type == "cpu":
        return 0, 1
    card = local_rank % local_devices
    return local_rank // local_devices, len(range(card, local_ranks, local_devices))


def local_device(device_type: str, local_rank: int, local_devices: int) -> torch.device:
    """The device of the host's ``local_rank``-th rank: the CPU, or card
    ``local_rank % local_devices`` (ranks share cards when there are fewer
    cards than ranks)."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % local_devices)


def make_store(init_method: str, rank: int, world_size: int):
    """The rendezvous store: ``file://<path>`` (a file every rank can
    reach) or ``tcp://<host>:<port>`` (rank 0 serves it)."""
    import torch.distributed as dist

    if init_method.startswith("file://"):
        return dist.FileStore(init_method[len("file://"):], world_size)
    if init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world_size, is_master=rank == 0,
                             timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
                             wait_for_workers=False)
    raise ValueError(f"rendezvous {init_method!r}: expected file://<path> or tcp://<host>:<port>")


def _process_group(backend: str, store, rank: int, size: int, timeout, device):
    import torch.distributed as dist

    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    if backend == "nccl":
        torch.cuda.set_device(device)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"unknown backend {backend!r}")


class TpGroup:
    """One rank of a tensor-parallel group (see the module docstring)."""

    def __init__(self, tp: int, rank: int, device, *, backend: Optional[str] = None,
                 stage_on_host: bool = False, device_share: Tuple[int, int] = (0, 1),
                 tensor_pg=None, payload_pg=None):
        self.tp = tp
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.stage_on_host = stage_on_host
        # (this rank's place among the ranks on its device, their number).
        self.device_share = device_share
        self._tensor_pg = tensor_pg
        self._payload_pg = payload_pg
        # The rendezvous store, for the pipeline stages' NCCL groups.
        self._store = None
        # Collectives this rank has issued (tensor and payload), shared
        # with its stage groups: the smoke reads it per engine step.
        self._count = [0]
        # The capture's stand-in for this group's tensor collectives, per
        # thread (:meth:`segmented`).
        self._local = threading.local()

    @property
    def collectives(self) -> int:
        return self._count[0]

    @collectives.setter
    def collectives(self, value: int) -> None:
        self._count[0] = value

    def for_stage(self, stage: int, device) -> "TpGroup":
        """This rank's group for pipeline stage ``stage`` on ``device``: the
        same ranks, payload group and collectives count; under NCCL a
        tensor process group of its own bound to ``device`` (every rank
        builds its stages' groups in stage order), else this group's. Stage
        0 on the rank's own device is the group itself."""
        device = torch.device(device)
        if stage == 0 and device == self.device:
            return self
        group = copy.copy(self)
        group.device = device
        group._local = threading.local()
        if self.backend == "nccl":
            import torch.distributed as dist

            group._tensor_pg = _process_group(
                "nccl", dist.PrefixStore(f"atoma/tensor/stage{stage}", self._store), self.rank,
                self.tp, COLLECTIVE_TIMEOUT, device)
            torch.cuda.set_device(self.device)
        return group

    @classmethod
    def join(cls, *, tp: int, rank: int, device, init_method: str, backend: str,
             stage_on_host: bool, device_share: Tuple[int, int] = (0, 1),
             watch: Optional[Callable[[], None]] = None) -> "TpGroup":
        """Join the rendezvous at ``init_method`` as ``rank`` of ``tp`` and
        build the group's process groups. Rank 0 waits for every rank to
        join, calling ``watch`` between polls (it raises when a rank it
        started has died), so a rank that fails before joining fails the
        start instead of hanging it."""
        import torch.distributed as dist

        store = make_store(init_method, rank, tp)
        store.set(f"atoma/joined/{rank}", "1")
        if rank == 0:
            keys = [f"atoma/joined/{r}" for r in range(tp)]
            deadline = time.monotonic() + JOIN_TIMEOUT_S
            while not store.check(keys):
                if watch is not None:
                    watch()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"tensor parallelism: not every one of {tp} ranks "
                                       f"joined {init_method} in {JOIN_TIMEOUT_S:.0f} s")
                time.sleep(0.05)
        tensor_pg = _process_group(backend, dist.PrefixStore("atoma/tensor", store), rank, tp,
                                   COLLECTIVE_TIMEOUT, device)
        payload_pg = _process_group("gloo", dist.PrefixStore("atoma/payload", store), rank, tp,
                                    IDLE_TIMEOUT, device)
        group = cls(tp, rank, device, backend=backend, stage_on_host=stage_on_host,
                    device_share=device_share, tensor_pg=tensor_pg, payload_pg=payload_pg)
        group._store = store
        logger.info("tensor parallelism: rank %d of %d on %s, backend %s%s", rank, tp,
                    group.device, backend,
                    " (a shared card: collectives staged through host memory)"
                    if stage_on_host else "")
        return group

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    # ------------------------------------------------------------- capture
    @contextlib.contextmanager
    def segmented(self, cut: Callable[[str, torch.Tensor], torch.Tensor]):
        """While a CUDA graph of a step is captured on this thread: each of
        this group's tensor collectives is ``cut(op, x)`` instead — ``op``
        "sum", "max" or "gather", ``x`` the tensor it works on — which
        returns the tensor the model reads on (``x`` for the all-reduces,
        ``[…, tp·n]`` for the gather). No collective is issued or counted.
        Other threads' collectives stay real."""
        if self._cut() is not None:
            raise RuntimeError("a capture is already cutting this group's collectives")
        self._local.cut = cut
        try:
            yield
        finally:
            self._local.cut = None

    def _cut(self):
        return getattr(self._local, "cut", None)

    # ------------------------------------------------------------- tensors
    def _staged(self, x: torch.Tensor) -> bool:
        return self.stage_on_host and x.is_cuda

    @staticmethod
    def _to_host(x: torch.Tensor) -> torch.Tensor:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)  # waits for the stream: the values are final
        return host

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        self.collectives += 1
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        staged = self._staged(x)
        buf = self._to_host(x) if staged else x.contiguous()
        self._tensor_pg.allreduce([buf], opts).wait()
        if staged:
            x.copy_(buf)
            return x
        return buf

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the ranks → the result (``x`` itself, reduced
        in place, when it is contiguous). Every rank gets the same bits."""
        import torch.distributed as dist

        cut = self._cut()
        if cut is not None:
            return cut("sum", x)
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks (as :meth:`all_reduce_sum`)."""
        import torch.distributed as dist

        cut = self._cut()
        if cut is not None:
            return cut("max", x)
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_gather_last(self, x: torch.Tensor, out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Every rank's ``x`` [..., n] concatenated on the last dim in rank
        order → [..., tp·n]; written into ``out`` when it is given (a
        segmented graph's static output)."""
        cut = self._cut()
        if cut is not None:
            return cut("gather", x)
        self.collectives += 1
        staged = self._staged(x)
        src = self._to_host(x) if staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.tp)]
        self._tensor_pg.allgather([parts], [src]).wait()
        gathered = torch.cat(parts, dim=-1)
        if out is not None:
            return out.copy_(gathered)
        return gathered.to(x.device) if staged else gathered

    # ------------------------------------------------------------ host data
    def broadcast_bytes(self, buf: Optional[np.ndarray], size: int, src: int = 0) -> np.ndarray:
        """``src``'s uint8 buffer of ``size`` bytes → every rank (the others
        pass None)."""
        import torch.distributed as dist

        self.collectives += 1
        if self.rank == src:
            t = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8).copy())
            if t.numel() != size:
                raise ValueError(f"broadcast_bytes: {t.numel()} bytes, {size} announced")
        else:
            t = torch.zeros(size, dtype=torch.uint8)
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self._payload_pg.broadcast([t], opts).wait()
        return t.numpy()

    def min_int(self, value: int) -> int:
        """The least of every rank's ``value`` (the KV pools' block counts)."""
        import torch.distributed as dist

        t = torch.tensor([int(value)], dtype=torch.int64)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MIN
        self._payload_pg.allreduce([t], opts).wait()
        return int(t.item())

    def barrier(self) -> None:
        self._payload_pg.barrier().wait()
