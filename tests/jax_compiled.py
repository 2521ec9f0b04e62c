"""The JAX package's attention references, compiled once per shape.

The port's attention tests hold its plain versions and kernel models
against JAX's XLA branch (``ops/attention.py``) and its Pallas kernels in
interpret mode (``ops/paged_attention.py``). Called eagerly, each of these
traces and compiles anew on every call (three to five seconds on a CPU).
Here each is wrapped in ``jax.jit`` once, in this module, so every test of
a worker process shares one compile per shape and static arguments (the
scale, the window, the soft cap, ``interpret``), and the compile runs with
XLA's backend optimisation off, about a second a shape. The functions, their
arguments and their results are JAX's own.
"""

import jax

from atoma_infer_tpu.ops import attention as jax_attention
from atoma_infer_tpu.ops import paged_attention as jax_paged

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
_STATIC = ("scale", "sliding_window", "soft_cap")


def _compiled(fn, *static):
    return jax.jit(fn, static_argnames=_STATIC + static, compiler_options=FAST_COMPILE)


ragged_paged_attention = _compiled(jax_attention.ragged_paged_attention)
paged_attention_layer = _compiled(jax_attention.paged_attention_layer, "mesh", "page_map")
ragged_paged_attention_pallas = _compiled(jax_paged.ragged_paged_attention_pallas, "interpret",
                                          "block_q", "pages_per_chunk")
ragged_paged_attention_fused = _compiled(jax_paged.ragged_paged_attention_fused, "interpret")
ragged_paged_attention_fused_quant = _compiled(jax_paged.ragged_paged_attention_fused_quant,
                                               "interpret")
