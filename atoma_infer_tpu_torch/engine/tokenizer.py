"""Async tokenizer worker pool.

Ref: backends/vllm/src/tokenizer.rs — a round-robin pool of N blocking encode
workers over HF ``tokenizers`` (:43-70,148-166) with char-level left
truncation before encode (:185-206). Here the pool is a
``ThreadPoolExecutor`` (HF tokenizers release the GIL for rust-side encode)
fronted by asyncio.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple


class TokenizerPool:
    """N-worker encode/decode pool (ref: tokenizer.rs:43-70)."""

    def __init__(self, tokenizer, num_workers: int = 4):
        self.tokenizer = tokenizer
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, num_workers), thread_name_prefix="tokenizer"
        )

    def encode_sync(
        self, inputs: str, truncate: Optional[int] = None
    ) -> Tuple[str, List[int]]:
        """Encode, with char-level truncation from the left first
        (ref: tokenizer.rs:185-206)."""
        if truncate is not None and truncate > 0:
            inputs = inputs[-truncate:]
        ids = self.tokenizer.encode(inputs)
        token_ids = ids.ids if hasattr(ids, "ids") else ids
        return inputs, list(token_ids)

    async def encode(
        self, inputs: str, truncate: Optional[int] = None
    ) -> Tuple[str, List[int]]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool, self.encode_sync, inputs, truncate
        )

    def decode_sync(self, token_ids: List[int]) -> str:
        return self.tokenizer.decode(token_ids, skip_special_tokens=True)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
