"""The port's HTTP server: ``tests/test_server.py`` against the port's
``build_app`` over a port service on the CPU (chat completions plain and
SSE, schema validation, health, metrics, chat templates), plus warmup: the
port's ``LlmService.warmup`` then a request, as
``tests/test_engine_integration.py::test_warmup_then_serve`` runs it, and
``build_app(warmup=True)`` calling it before traffic."""

import asyncio
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

from atoma_infer_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
    ValidationConfig,
)
from atoma_infer_tpu_torch.engine.llm_service import LlmService
from atoma_infer_tpu_torch.entrypoints.offline import build_tiny_random
from atoma_infer_tpu_torch.server.app import build_app
from atoma_infer_tpu_torch.server.chat_templates import (
    render_hermes3,
    render_llama2,
    render_llama3,
)
from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest


def make_service(async_scheduling=False) -> LlmService:
    """The port's service over tiny-random on the CPU, configured as
    ``tests/test_engine_integration.py``'s ``make_service``."""
    model, params, tokenizer = build_tiny_random("cpu")
    config = EngineConfig(
        model=ModelConfig(model_name="tiny-random", dtype="float32"),
        cache=CacheConfig(
            block_size=16,
            num_device_blocks_override=128,
            num_host_blocks_override=32,
        ),
        scheduler=SchedulerConfig(
            max_num_batched_tokens=512,
            max_num_sequences=16,
            max_model_len=512,
            enable_chunked_prefill=False,
            async_scheduling=async_scheduling,
        ),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    return LlmService.start(
        config, model=model, params=params, tokenizer=tokenizer, device="cpu"
    )


@pytest.fixture()
def client(event_loop=None):
    # One service per test; aiohttp TestClient drives the app in-process.
    service = make_service()
    app = build_app(service)
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(app, loop=loop), loop=loop)
    loop.run_until_complete(client.start_server())
    yield client, loop
    loop.run_until_complete(client.close())
    loop.close()


BODY = {
    "model": "meta-llama/Llama-3.2-1B-Instruct",
    "messages": [
        {"role": "system", "content": "You are helpful."},
        {"role": "user", "content": "Say hi"},
    ],
    "max_tokens": 6,
}


class TestServerEndpoints:
    def test_healthz(self, client):
        c, loop = client

        async def go():
            resp = await c.get("/healthz")
            assert resp.status == 200
            assert (await resp.json())["status"] == "ok"

        loop.run_until_complete(go())

    def test_completion(self, client):
        c, loop = client

        async def go():
            resp = await c.post("/v1/chat/completions", json=BODY)
            assert resp.status == 200, await resp.text()
            data = await resp.json()
            assert data["object"] == "chat.completion"
            assert data["choices"][0]["finish_reason"] in ("length", "stop")
            assert data["usage"]["prompt_tokens"] > 0
            assert 1 <= data["usage"]["completion_tokens"] <= 6

        loop.run_until_complete(go())

    def test_streaming_sse(self, client):
        c, loop = client

        async def go():
            resp = await c.post(
                "/v1/chat/completions", json={**BODY, "stream": True}
            )
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/event-stream")
            raw = await resp.text()
            events = [
                line[len("data: "):]
                for line in raw.splitlines()
                if line.startswith("data: ")
            ]
            assert events[-1] == "[DONE]"
            chunks = [json.loads(e) for e in events[:-1]]
            assert chunks, "no streamed chunks"
            assert chunks[0]["object"] == "chat.completion.chunk"
            assert chunks[-1]["choices"][0]["finish_reason"] in (
                "length",
                "stop",
            )

        loop.run_until_complete(go())

    def test_validate_endpoint(self, client):
        c, loop = client

        async def go():
            resp = await c.post("/v1/chat/completions/validate", json=BODY)
            assert (await resp.json())["valid"]
            bad = {**BODY, "temperature": 99}
            resp = await c.post("/v1/chat/completions/validate", json=bad)
            data = await resp.json()
            assert not data["valid"]
            assert any("temperature" in e["path"] for e in data["errors"])

        loop.run_until_complete(go())

    def test_bad_request_400(self, client):
        c, loop = client

        async def go():
            resp = await c.post("/v1/chat/completions", json={"model": "x"})
            assert resp.status == 400
            resp = await c.post(
                "/v1/chat/completions",
                data="not json",
                headers={"Content-Type": "application/json"},
            )
            assert resp.status == 400

        loop.run_until_complete(go())

    def test_invalid_params_422(self, client):
        c, loop = client

        async def go():
            resp = await c.post(
                "/v1/chat/completions", json={**BODY, "top_p": 7.0}
            )
            assert resp.status == 422

        loop.run_until_complete(go())

    def test_metrics_exported(self, client):
        c, loop = client

        async def go():
            await c.post("/v1/chat/completions", json=BODY)
            resp = await c.get("/metrics")
            text = await resp.text()
            assert "llm_service_requests_total" in text
            assert "engine_generated_tokens_total" in text

        loop.run_until_complete(go())

    def test_openapi(self, client):
        c, loop = client

        async def go():
            resp = await c.get("/openapi.json")
            spec = await resp.json()
            assert "/v1/chat/completions" in spec["paths"]

        loop.run_until_complete(go())


class TestChatTemplates:
    def test_llama3_format(self):
        out = render_llama3(BODY["messages"])
        assert out.startswith("<|begin_of_text|>")
        assert "<|start_header_id|>system<|end_header_id|>" in out
        assert out.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")

    def test_llama2_format(self):
        out = render_llama2(BODY["messages"])
        assert out.startswith("<s>[INST] <<SYS>>")
        assert "[/INST]" in out

    def test_hermes3_format(self):
        out = render_hermes3(BODY["messages"])
        assert "<|im_start|>system" in out
        assert out.endswith("<|im_start|>assistant\n")

    def test_llama3_tools(self):
        tools = [{"type": "function", "function": {"name": "get_weather"}}]
        out = render_llama3(BODY["messages"], tools)
        assert "get_weather" in out

    def test_llama3_assistant_tool_calls(self):
        """Assistant tool-call turns render as a <|python_tag|> function-call
        list and REPLACE the content; tool results render as ipython turns
        (ref: chat_completions.rs:351-433,597-640)."""
        msgs = [
            {"role": "user", "content": "weather in SF?"},
            {
                "role": "assistant",
                "content": None,
                "tool_calls": [
                    {
                        "id": "call_1",
                        "type": "function",
                        "function": {
                            "name": "get_weather",
                            # OpenAI sends arguments as a JSON string.
                            "arguments": '{"city": "SF", "days": 2, "metric": true}',
                        },
                    }
                ],
            },
            {"role": "tool", "tool_call_id": "call_1", "content": "72F sunny"},
        ]
        out = render_llama3(msgs)
        assert (
            "<|start_header_id|>assistant<|end_header_id|>\n\n"
            "<|python_tag|>[get_weather(city='SF', days=2, metric=true)]"
            "<|eot_id|>" in out
        )
        assert (
            "<|start_header_id|>ipython<|end_header_id|>\n\n72F sunny<|eot_id|>"
            in out
        )

    def test_llama3_tool_call_arg_shapes(self):
        """Arguments as object / unparseable string / missing — the three
        reference branches (chat_completions.rs:602-640)."""
        def one(args):
            return render_llama3(
                [
                    {
                        "role": "assistant",
                        "tool_calls": [
                            {
                                "type": "function",
                                "function": {"name": "f", "arguments": args},
                            }
                        ],
                    }
                ]
            )

        assert "<|python_tag|>[f(a='b')]" in one({"a": "b"})
        assert "<|python_tag|>[f(not json)]" in one("not json")
        assert "<|python_tag|>[f()]" in one(None)

    def test_llama3_multiple_tool_calls(self):
        out = render_llama3(
            [
                {
                    "role": "assistant",
                    "tool_calls": [
                        {"type": "function", "function": {"name": "a", "arguments": {"x": 1}}},
                        {"type": "function", "function": {"name": "b", "arguments": {}}},
                    ],
                }
            ]
        )
        assert "<|python_tag|>[a(x=1), b()]" in out

    def test_hermes3_assistant_tool_calls(self):
        """Hermes3 wraps calls in <tool_call> JSON (space-after-colon quirk)
        and tool results in <|im_start|>tool turns
        (ref: chat_completions.rs:417-443,578-587)."""
        msgs = [
            {"role": "user", "content": "weather?"},
            {
                "role": "assistant",
                "tool_calls": [
                    {
                        "type": "function",
                        "function": {
                            "name": "get_weather",
                            "arguments": '{"city": "SF"}',
                        },
                    }
                ],
            },
            {"role": "tool", "content": "72F"},
        ]
        out = render_hermes3(msgs)
        assert (
            '<tool_call>{"arguments": {"city": "SF"}, "name": "get_weather"}'
            "</tool_call>" in out
        )
        assert "<|im_start|>tool\n72F<|im_end|>\n" in out

    def test_beyond_reference_families(self):
        """gemma/mistral/phi3/qwen templates for the extra registered
        families (the reference enum is llama/hermes only)."""
        from atoma_infer_tpu_torch.server.chat_templates import (
            family_for_model,
            render_prompt,
        )

        msgs = [
            {"role": "system", "content": "Be terse."},
            {"role": "user", "content": "hi"},
        ]
        assert family_for_model("google/gemma-2-9b-it") == "gemma"
        g = render_prompt("google/gemma-2-9b-it", msgs)
        # No system role in gemma: folded into the first user turn.
        assert g.startswith("<bos><start_of_turn>user\nBe terse.\n\nhi")
        assert g.endswith("<start_of_turn>model\n")
        assert "system" not in g

        m = render_prompt("mistralai/Mistral-7B-Instruct-v0.3", msgs)
        assert m.startswith("<s>[INST] Be terse.\n\nhi [/INST]")
        assert "<<SYS>>" not in m

        p = render_prompt("microsoft/Phi-3-mini-4k-instruct", msgs)
        assert "<|system|>\nBe terse.<|end|>\n" in p
        assert p.endswith("<|assistant|>\n")

        q = render_prompt("Qwen/Qwen2.5-7B-Instruct", msgs)
        assert "<|im_start|>system\nBe terse.<|im_end|>" in q
        assert q.endswith("<|im_start|>assistant\n")

    def test_multi_turn_gemma_and_mistral(self):
        from atoma_infer_tpu_torch.server.chat_templates import (
            render_gemma,
            render_mistral,
        )

        msgs = [
            {"role": "user", "content": "a"},
            {"role": "assistant", "content": "b"},
            {"role": "user", "content": "c"},
        ]
        g = render_gemma(msgs)
        assert (
            "<start_of_turn>user\na<end_of_turn>\n"
            "<start_of_turn>model\nb<end_of_turn>\n"
            "<start_of_turn>user\nc<end_of_turn>\n" in g
        )
        m = render_mistral(msgs)
        assert m == "<s>[INST] a [/INST] b</s><s>[INST] c [/INST]"

    def test_unknown_model_rejected(self, client):
        c, loop = client

        async def go():
            body = dict(BODY, model="definitely-not-a-model")
            resp = await c.post("/v1/chat/completions", json=body)
            assert resp.status == 400
            data = await resp.json()
            assert "unknown model" in data["error"]["message"]
            # Known reference-enum ids pass model validation (they then fail
            # later only if the chat template needs a family — llama works).
            body2 = dict(BODY, model="meta-llama/Llama-3.2-1B-Instruct")
            resp2 = await c.post("/v1/chat/completions", json=body2)
            assert resp2.status == 200

        loop.run_until_complete(go())

    def test_models_endpoint(self, client):
        c, loop = client

        async def go():
            resp = await c.get("/v1/models")
            assert resp.status == 200
            data = await resp.json()
            ids = [m["id"] for m in data["data"]]
            assert "tiny-random" in ids
            assert "meta-llama/Llama-3.1-8B-Instruct" in ids

        loop.run_until_complete(go())

    def test_docs_page(self, client):
        c, loop = client

        async def go():
            resp = await c.get("/docs")
            assert resp.status == 200
            text = await resp.text()
            assert "openapi.json" in text

        loop.run_until_complete(go())

    def test_top_logprobs_in_response(self, client):
        c, loop = client

        async def go():
            body = dict(BODY, logprobs=True, top_logprobs=2, max_tokens=3)
            resp = await c.post("/v1/chat/completions", json=body)
            assert resp.status == 200, await resp.text()
            content = (await resp.json())["choices"][0]["logprobs"]["content"]
            assert len(content) >= 1
            for entry in content:
                assert len(entry["top_logprobs"]) == 2
                lps = [t["logprob"] for t in entry["top_logprobs"]]
                assert lps == sorted(lps, reverse=True)

        loop.run_until_complete(go())


class TestWarmup:
    def test_warmup_then_serve(self):
        """The port's ``warmup`` runs its waves through the engine and
        leaves it serviceable: no warmup group lingers, every block is back,
        a real request completes (the CPU worker captures no graph)."""

        async def scenario():
            service = make_service(async_scheduling=True)
            task = asyncio.create_task(service.engine.run())
            dt = await service.warmup(num_seqs=4, prompt_len=16)
            assert dt > 0
            assert all(
                not rid.startswith("_warmup") for rid in service.engine._groups
            )
            fut = await service.handle_request(
                GenerateRequest(
                    request_id="after-warmup",
                    inputs="hello there",
                    parameters=GenerateParameters(max_new_tokens=8),
                )
            )
            r = await asyncio.wait_for(fut, timeout=120)
            service.stop()
            task.cancel()
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            return r, free, service.engine.worker.graphs

        r, free, graphs = asyncio.run(scenario())
        assert len(r.outputs[0].token_ids) >= 1
        assert free == 128
        assert graphs is None

    def test_build_app_warmup_runs_before_serving(self):
        service = make_service(async_scheduling=True)
        calls = []
        warmup = service.warmup

        async def spy(**kw):
            calls.append(kw)
            return await warmup(num_seqs=2, prompt_len=8, max_new=2)

        service.warmup = spy
        loop = asyncio.new_event_loop()
        c = TestClient(TestServer(build_app(service, warmup=True), loop=loop), loop=loop)
        try:
            loop.run_until_complete(c.start_server())
            assert len(calls) == 1

            async def go():
                resp = await c.post("/v1/chat/completions", json=BODY)
                assert resp.status == 200, await resp.text()
                data = await resp.json()
                assert 1 <= data["usage"]["completion_tokens"] <= 6

            loop.run_until_complete(go())
        finally:
            loop.run_until_complete(c.close())
            loop.close()
