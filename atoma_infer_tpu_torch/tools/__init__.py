"""The port's tools on the card: the quantization gates, the probes, the benches.

Counterparts of the JAX repository's ``tools/`` scripts, each an import-safe
module with a ``main()``, run as ``python -m atoma_infer_tpu_torch.tools.<name>``:

- ``w8a8_probe``     — the int8 x int8 vs bf16 x int8 matmul rate (kernel I)
- ``probe_ablation`` — where kernel I's time goes (its loop with parts removed)
- ``w8a8_gate``      — logprob drift of W8A8 activations on random weights
- ``kv_quant_gate``  — logprob drift of an INT8 KV cache on random weights
- ``quality_ladder`` — every quantization variant on a trained checkpoint
- ``tiny_corpus``    — the deterministic corpus the ladder's prompts come from
- ``decode_harness`` — the teacher-forced decode loop the gates share
- ``attn_bench``     — the fused decode kernels' KV bandwidth by context length
- ``engine_step_probe`` — the decode step's device cost against its host overhead
- ``roofline``       — the card's peaks and an attention call's least time

Each defaults to the card and raises without a GPU; ``--device cpu``
(``--cpu`` for ``attn_bench`` and ``engine_step_probe``, as their JAX
counterparts take it) runs the plain PyTorch versions of the kernels.
"""
