"""atoma_infer_tpu_torch — the PyTorch/CUDA port of atoma_infer_tpu for an
NVIDIA H100.

The JAX package ``atoma_infer_tpu`` stays the reference; this package imports
nothing of it (it keeps its own copies of the framework-free modules) and
nothing of JAX. Its Pallas kernels are ported as hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, each beside a plain PyTorch version that CPU
tensors take.

Layer map (mirrors the JAX package):
  server/  — the OpenAI-compatible HTTP server (copies)
  engine/  — service admission, continuous batching (sync or async), worker,
             pure-decode CUDA graphs, sampling, the tensor-parallel lockstep
  parallel/ — tensor parallelism across processes: rank groups and their
             collectives, sharding rules, the step broadcast
  core/    — scheduler + paged-KV block manager (copies)
  models/  — Llama in PyTorch over per-layer paged caches
  ops/     — CUDA kernels + plain versions, attention dispatch
"""

__version__ = "0.1.0"
