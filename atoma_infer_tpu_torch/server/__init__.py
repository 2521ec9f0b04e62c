"""OpenAI-compatible HTTP serving layer of the PyTorch port.

The port's copies of ``atoma_infer_tpu/server``: aiohttp routes, SSE
streaming, the JSON-schema validation endpoint, chat-template rendering per
model family and live Prometheus metrics, over the port's ``LlmService``.
"""
