"""Parallelism: tensor parallelism across processes (counterpart of
``atoma_infer_tpu/parallel/``).

JAX runs tensor parallelism as ONE SPMD program over a device mesh; PyTorch
runs one process per rank. ``group`` holds a rank's process groups and the
collectives the model calls, ``sharding`` cuts a rank's parameter slices by
the JAX package's rules, and ``distributed`` joins the ranks and broadcasts
each engine step's payload from rank 0 (the lockstep of
``engine/multihost.py``). Tensor parallelism within a host and across hosts
are the same code with other rank layouts. ``pipeline`` splits the layers
into stages (``engine/pp_worker.py`` runs them), and ``context_parallel``
splits one layer's KV pages over the ranks and combines their partial
attention.
"""

from .group import TpGroup, choose_backend, local_device  # noqa: F401
from .sharding import check_divisibility, kv_repeat, shard_params  # noqa: F401
