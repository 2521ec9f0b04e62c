"""aiohttp application: routes, SSE streaming, graceful shutdown.

Ref: server/src/server.rs — the axum router (:126-133), completion handler
(:248), non-streaming (:364) and streaming (:455) request handling, the
``[DONE]`` SSE terminator + keep-alive (stream.rs:71-109), 30 s graceful
shutdown (:152-162), and the (unrouted in the reference) ``/healthz``
(:195-204) — routed here, plus live ``/metrics`` and an abort endpoint.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional

from aiohttp import web

from ..engine.llm_service import LlmService
from ..engine.validation import ValidationError
from . import api, metrics, schema

logger = logging.getLogger(__name__)

GRACEFUL_SHUTDOWN_TIMEOUT_S = 30.0  # ref: server.rs:152-162


def _error(status: int, message: str) -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": "invalid_request_error"}},
        status=status,
    )


async def completion_handler(request: web.Request) -> web.StreamResponse:
    """POST /v1/chat/completions (ref: server.rs:248-326)."""
    service: LlmService = request.app["service"]
    metrics.REQUESTS_TOTAL.inc()
    served = service.config.model.model_name
    try:
        body = api.parse_request_body(await request.json(), served_model=served)
    except api.ApiError as e:
        return _error(400, str(e))
    except json.JSONDecodeError:
        return _error(400, "invalid JSON body")

    gen_request = api.to_generate_request(body)
    metrics.MAX_NEW_TOKENS.observe(
        gen_request.parameters.max_new_tokens or 0
    )
    stream = bool(body.get("stream"))
    t0 = time.monotonic()
    try:
        if stream:
            fut, queue = await service.handle_request(gen_request, stream=True)
        else:
            fut = await service.handle_request(gen_request)
    except ValidationError as e:
        return _error(422, str(e))
    metrics.VALIDATION_TIME.observe(time.monotonic() - t0)

    if not stream:
        result = await fut
        _observe_result(result)
        prompt_tokens = len(result.prompt_token_ids)
        return web.json_response(
            api.completion_response(result, body["model"], prompt_tokens)
        )

    # SSE streaming (ref: server.rs:455-488, stream.rs:14-110).
    response = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        },
    )
    await response.prepare(request)
    # Env knobs (ref: main.rs:64-67 STREAMING_INTERVAL_IN_MILLIS, default
    # 100 there; default 0 here = flush every token immediately). The SSE
    # keep-alive comment interval is ours (the reference sends none).
    interval_s = (
        float(os.environ.get("STREAMING_INTERVAL_IN_MILLIS", "0") or 0)
        / 1000.0
    )
    keepalive_s = float(os.environ.get("ATOMA_SSE_KEEPALIVE_SECS", "15") or 15)
    try:
        done = False
        while not done:
            try:
                chunk = await asyncio.wait_for(
                    queue.get(), timeout=keepalive_s
                )
            except asyncio.TimeoutError:
                await response.write(b": keep-alive\n\n")
                continue
            if interval_s > 0:
                # Coalesce tokens arriving within the flush interval.
                await asyncio.sleep(interval_s)
            chunks = [chunk]
            while True:
                try:
                    chunks.append(queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            for chunk in chunks:
                if chunk is None:
                    done = True
                    break
                payload = api.chunk_response(
                    gen_request.request_id,
                    body["model"],
                    chunk.text,
                    chunk.finish_reason if chunk.finished else None,
                )
                await response.write(
                    f"data: {json.dumps(payload)}\n\n".encode()
                )
        await response.write(b"data: [DONE]\n\n")
        result = await fut
        _observe_result(result)
    except (ConnectionResetError, asyncio.CancelledError):
        # Client went away: abort the request to reclaim KV blocks.
        service.engine.abort_request(gen_request.request_id)
    await response.write_eof()
    return response


def _observe_result(result) -> None:
    m = result.metrics
    if m.first_token_time is not None:
        metrics.TIME_TO_FIRST_TOKEN.observe(
            m.first_token_time - m.arrival_time
        )
    if m.finished_time is not None:
        metrics.ARRIVAL_TO_FINISH.observe(m.finished_time - m.arrival_time)
    metrics.INPUT_LENGTH.observe(len(result.prompt_token_ids))
    # GENERATED_TOKENS is incremented per token in the engine
    # (LlmEngine._update_sequence) — not here, or every token counts twice.


async def validate_handler(request: web.Request) -> web.Response:
    """POST /v1/chat/completions/validate (ref: server.rs:310-326)."""
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return web.json_response(
            {"valid": False, "errors": [{"path": "<root>", "message": "invalid JSON"}]}
        )
    errors = schema.validate_with_schema(body)
    return web.json_response({"valid": not errors, "errors": errors})


async def abort_handler(request: web.Request) -> web.Response:
    """POST /v1/abort/{request_id} — routed abort (the reference exposes the
    scheduler API but never routes it, SURVEY.md §3.5)."""
    service: LlmService = request.app["service"]
    request_id = request.match_info["request_id"]
    ok = service.engine.abort_request(request_id)
    return web.json_response({"aborted": ok}, status=200 if ok else 404)


async def healthz_handler(request: web.Request) -> web.Response:
    """GET /healthz (ref: server.rs:195-204 — routed here)."""
    return web.json_response({"status": "ok"})


async def metrics_handler(request: web.Request) -> web.Response:
    return web.Response(
        text=metrics.REGISTRY.expose(), content_type="text/plain"
    )


async def openapi_handler(request: web.Request) -> web.Response:
    """GET /openapi.json — the Swagger-docs analog (ref: server.rs:41)."""
    return web.json_response(_OPENAPI_SPEC)


async def models_handler(request: web.Request) -> web.Response:
    """GET /v1/models — served model + the supported model-id enum."""
    service: LlmService = request.app["service"]
    served = service.config.model.model_name
    ids = [served] + sorted(api.KNOWN_MODELS - {served})
    return web.json_response(
        {
            "object": "list",
            "data": [
                {"id": m, "object": "model", "owned_by": "atoma-infer-tpu"}
                for m in ids
            ],
        }
    )


_DOCS_HTML = """<!doctype html>
<html><head><title>atoma-infer-tpu API</title><style>
body{font-family:system-ui,sans-serif;margin:2em;max-width:60em}
h1{font-size:1.4em} .m{display:inline-block;min-width:3.5em;font-weight:700;
color:#fff;background:#2a7;border-radius:4px;padding:2px 8px;margin-right:8px;
text-align:center} .m.post{background:#27c} .path{font-family:monospace;
font-size:1.05em} .op{margin:1em 0;padding:.6em;border:1px solid #ddd;
border-radius:6px} pre{background:#f6f6f6;padding:.8em;overflow:auto}
</style></head><body><h1>atoma-infer-tpu API</h1>
<p>Interactive reference rendered from <a href="/openapi.json">openapi.json</a>
(the reference serves Swagger UI here — server.rs:41).</p>
<div id="ops">loading…</div>
<script>
fetch('/openapi.json').then(r=>r.json()).then(spec=>{
  const el=document.getElementById('ops'); el.innerHTML='';
  for(const [path,methods] of Object.entries(spec.paths)){
    for(const [method,op] of Object.entries(methods)){
      const d=document.createElement('div'); d.className='op';
      let html=`<span class="m ${method}">${method.toUpperCase()}</span>`+
        `<span class="path">${path}</span><p>${op.summary||''}</p>`;
      const schema=op.requestBody?.content?.['application/json']?.schema;
      if(schema) html+=`<details><summary>request schema</summary>`+
        `<pre>${JSON.stringify(schema,null,2)}</pre></details>`;
      d.innerHTML=html; el.appendChild(d);
    }
  }
});
</script></body></html>"""


async def docs_handler(request: web.Request) -> web.Response:
    """GET /docs — self-contained API docs page (no external assets)."""
    return web.Response(text=_DOCS_HTML, content_type="text/html")


_OPENAPI_SPEC = {
    "openapi": "3.0.0",
    "info": {"title": "atoma-infer-tpu", "version": "0.1.0"},
    "paths": {
        "/v1/chat/completions": {
            "post": {
                "summary": "OpenAI-compatible chat completion",
                "requestBody": {
                    "content": {
                        "application/json": {"schema": schema.REQUEST_SCHEMA}
                    }
                },
                "responses": {"200": {"description": "completion"}},
            }
        },
        "/v1/chat/completions/validate": {
            "post": {"summary": "Validate a request body against the schema"}
        },
        "/v1/abort/{request_id}": {"post": {"summary": "Abort a request"}},
        "/v1/models": {"get": {"summary": "Served + supported model ids"}},
        "/healthz": {"get": {"summary": "Liveness probe"}},
        "/metrics": {"get": {"summary": "Prometheus metrics"}},
        "/docs": {"get": {"summary": "This documentation page"}},
    },
}


def build_app(service: LlmService, warmup: bool = False) -> web.Application:
    app = web.Application()
    app["service"] = service
    app.router.add_post("/v1/chat/completions", completion_handler)
    app.router.add_post("/v1/chat/completions/validate", validate_handler)
    app.router.add_post("/v1/abort/{request_id}", abort_handler)
    app.router.add_get("/healthz", healthz_handler)
    app.router.add_get("/metrics", metrics_handler)
    app.router.add_get("/openapi.json", openapi_handler)
    app.router.add_get("/v1/models", models_handler)
    app.router.add_get("/docs", docs_handler)

    async def start_engine(app):
        app["engine_task"] = asyncio.create_task(service.engine.run())
        if warmup:
            # Pre-compile/pre-load the serving executables before taking
            # traffic (remote runtimes stall tens of seconds per program on
            # first dispatch; see LlmService.warmup). Runs during startup —
            # aiohttp binds the listener after on_startup completes, so the
            # first real request never eats the stall.
            await service.warmup()

    async def stop_engine(app):
        service.stop()
        task = app.get("engine_task")
        if task:
            task.cancel()
            try:
                await asyncio.wait_for(task, timeout=GRACEFUL_SHUTDOWN_TIMEOUT_S)
            except (asyncio.CancelledError, asyncio.TimeoutError):
                pass

    app.on_startup.append(start_engine)
    app.on_cleanup.append(stop_engine)
    return app


def run_server(
    service: LlmService,
    host: str = "0.0.0.0",
    port: int = 8080,
    warmup: bool = False,
) -> None:
    """Serve until SIGINT (ref: main.rs:69 → server.rs:120-162)."""
    web.run_app(
        build_app(service, warmup=warmup),
        host=host,
        port=port,
        shutdown_timeout=GRACEFUL_SHUTDOWN_TIMEOUT_S,
    )
