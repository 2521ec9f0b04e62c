"""The quantization decision tools on the card.

Counterparts of the JAX repository's ``tools/`` scripts, each an import-safe
module with a ``main()``, run as ``python -m atoma_infer_tpu_torch.tools.<name>``:

- ``w8a8_probe``     — the int8 x int8 vs bf16 x int8 matmul rate (kernel I)
- ``probe_ablation`` — where kernel I's time goes (its loop with parts removed)
- ``w8a8_gate``      — logprob drift of W8A8 activations on random weights
- ``kv_quant_gate``  — logprob drift of an INT8 KV cache on random weights
- ``quality_ladder`` — every quantization variant on a trained checkpoint
- ``tiny_corpus``    — the deterministic corpus the ladder's prompts come from
- ``decode_harness`` — the teacher-forced decode loop the gates share

Each defaults to ``--device cuda`` and raises without a GPU; ``--device cpu``
runs the plain PyTorch versions of the kernels.
"""
