"""Offline batch generation entrypoint of the PyTorch port.

Drives the full engine stack (service → engine → scheduler → worker → model)
without the HTTP layer, on the GPU unless ``--device`` says otherwise.

Usage:
    python -m atoma_infer_tpu_torch.entrypoints.offline --model tiny-random \
        --prompt "hello" --max-tokens 16
    python -m atoma_infer_tpu_torch.entrypoints.offline --model tiny-random \
        --device cpu
    python -m atoma_infer_tpu_torch.entrypoints.offline --model tiny-random \
        --device cpu --tensor-parallel-size 2 --pipeline-parallel-size 2

With ``--tensor-parallel-size`` > 1 the service starts one process per rank
(on the CPU, gloo), and this process, rank 0, drives the requests. With
``--pipeline-parallel-size`` > 1 every rank holds the model's layers in
that many stages.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
import uuid

import torch

from ..config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
    ValidationConfig,
)
from ..engine.llm_service import LlmService
from ..types import GenerateParameters, GenerateRequest


class ByteTokenizer:
    """Trivial byte-level tokenizer for random-weight smoke runs."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def encode(self, text: str):
        class _Enc:
            def __init__(self, ids):
                self.ids = ids

        return _Enc([b + 3 for b in text.encode("latin-1", errors="replace")])

    def decode(self, ids, skip_special_tokens=True):
        # latin-1: every byte is a valid char, so incremental decode never
        # stalls on incomplete fragments.
        return bytes(min(255, i - 3) for i in ids if i >= 3).decode("latin-1")


def tiny_random_config():
    """The tiny random Llama's configuration (f32, 2 layers, 4 q heads
    over 2 kv heads)."""
    from ..models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=32,
        max_position_embeddings=2048,
        rope_theta=10000.0,
        rope_scaling=None,
        tie_word_embeddings=True,
        eos_token_ids=(1,),
        bos_token_id=0,
    )


def build_tiny_random(device=None, seed: int = 0):
    """Random-weight tiny Llama (f32) on ``device`` (default: the GPU),
    weights drawn from a ``torch.Generator`` seeded with ``seed``."""
    from ..models.llama import Llama

    model = Llama(tiny_random_config(), dtype=torch.float32, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model, model.init_params(gen), ByteTokenizer(model.config.vocab_size)


async def main_async(args) -> None:
    config = EngineConfig(
        model=ModelConfig(model_name=args.model, dtype=args.dtype,
                          tensor_parallel_size=args.tensor_parallel_size,
                          pipeline_parallel_size=args.pipeline_parallel_size),
        cache=CacheConfig(
            block_size=args.block_size,
            num_device_blocks_override=args.num_blocks,
            num_host_blocks_override=args.num_blocks // 2 if args.num_blocks else None,
        ),
        scheduler=SchedulerConfig(
            max_num_batched_tokens=args.max_batched_tokens,
            max_num_sequences=args.max_seqs,
            max_model_len=args.max_model_len,
            enable_chunked_prefill=args.chunked_prefill,
            async_scheduling=args.async_scheduling,
        ),
        validation=ValidationConfig(
            max_input_tokens=args.max_model_len - 1,
            max_total_tokens=args.max_model_len,
        ),
    )
    if args.model == "tiny-random" and args.tensor_parallel_size == 1:
        model, params, tokenizer = build_tiny_random(args.device)
        service = LlmService.start(
            config, model=model, params=params, tokenizer=tokenizer, device=model.device
        )
    elif args.model == "tiny-random":  # every rank builds it
        service = LlmService.start(config, device=args.device)
    else:
        service = LlmService.start(config, model_dir=args.model, device=args.device)

    engine_task = asyncio.create_task(service.engine.run())

    prompts = args.prompt or ["The quick brown fox"]
    t0 = time.monotonic()
    futures = []
    for p in prompts:
        fut = await service.handle_request(
            GenerateRequest(
                request_id=str(uuid.uuid4()),
                inputs=p,
                parameters=GenerateParameters(
                    max_new_tokens=args.max_tokens,
                    do_sample=args.temperature > 0,
                    temperature=args.temperature or None,
                    top_p=args.top_p,
                    seed=args.seed,
                ),
            )
        )
        futures.append((p, fut))

    total_tokens = 0
    for p, fut in futures:
        result = await fut
        out = result.outputs[0]
        total_tokens += len(out.token_ids)
        print(f"--- prompt: {p!r}")
        print(
            f"    output ({len(out.token_ids)} tokens, "
            f"finish={out.finish_reason}): {out.output_text!r}"
        )
    dt = time.monotonic() - t0
    print(
        f"== {len(futures)} requests, {total_tokens} tokens in {dt:.2f}s "
        f"on {service.engine.worker.device}"
    )
    service.stop()
    engine_task.cancel()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default="tiny-random")
    parser.add_argument("--prompt", action="append")
    parser.add_argument("--max-tokens", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--num-blocks", type=int, default=256)
    parser.add_argument("--max-batched-tokens", type=int, default=2048)
    parser.add_argument("--max-seqs", type=int, default=64)
    parser.add_argument("--max-model-len", type=int, default=2048)
    parser.add_argument("--chunked-prefill", action="store_true")
    parser.add_argument("--async-scheduling", action="store_true")
    parser.add_argument("--tensor-parallel-size", type=int, default=1)
    parser.add_argument("--pipeline-parallel-size", type=int, default=1)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' takes the plain "
             "PyTorch path instead of the CUDA kernels)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    asyncio.run(main_async(args))


if __name__ == "__main__":
    main()
