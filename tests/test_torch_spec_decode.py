"""Speculative decoding in the port against the JAX package, on the CPU.

The port's n-gram drafts (``engine/spec_decode.py``), the verify layout of
``engine/input_prep.py``, the worker's verify step and its greedy
acceptance, and the engine's multi-token advance:

- the proposer and ``eligible_group`` against JAX's on seeded random token
  lists and groups;
- ``prepare_model_input`` with drafts against JAX's: the verify rows, the
  drafts, their counts, the token bucket and the packed arrays;
- one verify step's [S, K+1] tokens and logprobs against the JAX worker on
  ``tiny_trained`` (f32, 1e-4), and against K+1 decode steps of the port
  over the same tokens;
- ``LlmService`` with K drafts against the JAX service with the same K and
  against the port without drafts, synchronous and async: token-identical,
  with every end-to-end case of ``tests/test_spec_decode.py`` mirrored, a
  stop string and a length cap inside an accepted run, a seeded sampled
  request beside drafted ones, and a pool tight enough to swap and
  recompute;
- the verify steps' CUDA-graph keys, the static inputs' and the reserve's
  sizes at K > 0, and a service whose graphs are stubs that replay by
  recomputing (the card's path, rehearsed on the CPU).
"""

import asyncio
import functools

import numpy as np
import pytest
import torch

from test_torch_engine import (
    JAX,
    PORT,
    _jax_worker,
    _port_worker,
    _tiny_random,
    _tiny_trained,
    make_group,
    mod,
)

torch.set_num_threads(2)

# Logprobs of the same f32 step in the two packages (another summation
# order).
LOGPROB_TOL = 1e-4


# ------------------------------------------------------------ the proposer
@pytest.mark.parametrize("seed", range(4))
def test_ngram_proposer_matches_jax(seed):
    """The same drafts for the same tokens, K, n-gram range and cap."""
    jax_spec, port_spec = mod(JAX, "engine.spec_decode"), mod(PORT, "engine.spec_decode")
    rng = np.random.default_rng(seed)
    drafted = 0
    for _ in range(200):
        k = int(rng.integers(1, 6))
        n_min = int(rng.integers(1, 3))
        n_max = n_min + int(rng.integers(0, 3))
        tokens = rng.integers(0, int(rng.integers(2, 10)), size=int(rng.integers(0, 40))).tolist()
        cap = None if rng.random() < 0.5 else int(rng.integers(0, 6))
        want = jax_spec.NgramProposer(k, n_max, n_min).propose(tokens, cap)
        got = port_spec.NgramProposer(k, n_max, n_min).propose(tokens, cap)
        assert got == want
        drafted += bool(got)
    assert drafted > 50


def test_ngram_proposer_refuses_what_jax_refuses():
    for pkg in (JAX, PORT):
        proposer = mod(pkg, "engine.spec_decode").NgramProposer
        with pytest.raises(ValueError):
            proposer(0)
        with pytest.raises(ValueError):
            proposer(2, ngram_max=1, ngram_min=2)


GROUP_PARAMS = {
    # name: (best_of, top_n, parameters, drafted)
    "greedy": (1, 0, {}, True),
    "sampled": (1, 0, dict(do_sample=True, temperature=0.8, seed=3), False),
    "temperature0": (1, 0, dict(do_sample=True, temperature=0.0), True),
    "repetition": (1, 0, dict(repetition_penalty=1.2), False),
    "frequency": (1, 0, dict(frequency_penalty=0.5), False),
    "top_n": (1, 2, {}, False),
    "best_of": (2, 0, dict(do_sample=True, top_k=1, seed=1), False),
}


@pytest.mark.parametrize("name", sorted(GROUP_PARAMS))
def test_eligible_group_matches_jax(name):
    best_of, top_n, params, drafted = GROUP_PARAMS[name]
    answers = []
    for pkg in (JAX, PORT):
        group = make_group(pkg, "r", [3, 4, 5], max_new_tokens=8,
                           seq_ids=list(range(best_of)), **params)
        group.top_n_tokens = top_n
        answers.append(mod(pkg, "engine.spec_decode").eligible_group(group))
    assert answers == [drafted, drafted]


# --------------------------------------------------------- the verify layout
def _metadata(pkg, groups, **params):
    """Scheduler metadata of ``groups``: (seq_id, token ids, computed count,
    block table, prefill chunk or None, drafts)."""
    seq_mod, sp = mod(pkg, "sequence"), mod(pkg, "sampling_params")
    metas = []
    for seq_id, tokens, computed, table, chunk, drafts in groups:
        data = seq_mod.SequenceData(list(tokens))
        data.update_num_computed_tokens(computed)
        metas.append(seq_mod.SequenceGroupMetadata(
            request_id=f"r{seq_id}", is_prompt=chunk is not None, seq_data={seq_id: data},
            block_tables={seq_id: list(table)},
            next_token_chooser_params=sp.NextTokenChooserParameters(**params),
            stopping_criteria=sp.StoppingCriteriaParameters(), do_sample=True,
            token_chunk_size=chunk or 1, spec_token_ids=list(drafts) or None,
        ))
    return metas


def _decode(seq_id, length, drafts, first_block, block_size=16):
    """A decode row of ``length`` tokens (all but the last computed) with
    ``drafts``; its table covers the drafts' lookahead slots."""
    pages = -(-(length + len(drafts)) // block_size)
    tokens = [(7 * seq_id + j) % 500 + 3 for j in range(length)]
    return (seq_id, tokens, length - 1, range(first_block, first_block + pages), None, drafts)


LAYOUTS = {
    # name: (K, groups)
    "all_drafted": (4, [_decode(i, 20 + 5 * i, [9, 8, 7, 6], 4 * i) for i in range(5)]),
    "some_drafted": (4, [_decode(i, 30 + i, d, 4 * i) for i, d in
                         enumerate([[5, 6, 7, 8], [], [5, 6], [5], [], [9, 9, 9, 9]])]),
    "few_drafts": (3, [_decode(0, 17, [4], 0), _decode(1, 40, [], 4), _decode(2, 16, [3, 3], 8)]),
    "page_boundary": (3, [_decode(0, 15, [4, 5, 6], 0), _decode(1, 31, [7, 8], 4)]),
    "with_prefill": (3, [(10, list(range(3, 73)), 0, range(20, 25), 70, [])]
                     + [_decode(i, 25 + i, [5, 6, 7][: i + 1], 4 * i) for i in range(3)]),
    "with_prefill_chunk": (4, [(10, list(range(3, 53)), 16, range(20, 24), 24, [])]
                           + [_decode(i, 18, [6, 6, 6, 6], 4 * i) for i in range(2)]),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_prepare_model_input_with_drafts_matches_jax(name):
    K, groups = LAYOUTS[name]
    jprep = mod(JAX, "engine.input_prep").prepare_model_input(
        _metadata(JAX, groups), block_size=16, max_num_batched_tokens=512, max_num_seqs=16,
        max_pages_per_seq=16, num_spec_tokens=K)
    pprep = mod(PORT, "engine.input_prep").prepare_model_input(
        _metadata(PORT, groups), block_size=16, max_pages_per_seq=16, num_spec_tokens=K)
    for field in ("token_ids", "positions", "slot_mapping", "block_tables", "seq_lens",
                  "query_start_loc", "selected_token_indices", "sample_mask", "spec_rows",
                  "spec_draft", "spec_k"):
        np.testing.assert_array_equal(getattr(pprep, field), getattr(jprep, field), err_msg=field)
    assert pprep.token_ids.shape == jprep.token_ids.shape  # the token bucket T
    assert pprep.seq_ids == jprep.seq_ids and pprep.num_prefills == jprep.num_prefills
    assert pprep.decode_only is False
    assert pprep.decode_only == jprep.attention_metadata(16).decode_only
    assert pprep.spec_rows.shape == (pprep.block_tables.shape[0], K + 1)
    # The ragged kernel's plan is the key's: max_q_len is 1+K on a verify
    # step, however long its drafts; beside a prefill chunk, the chunk's
    # bucket (at least 1+K), capped at T.
    q_lens = np.diff(pprep.query_start_loc)
    want = max(1 + K, int(q_lens.max()))
    if pprep.num_prefills:
        want = mod(PORT, "engine.input_prep").bucket(want, maximum=pprep.token_ids.shape[0])
    assert pprep.max_q_len == want


def test_verify_bucket_is_exact_and_undrafted_steps_keep_the_fast_path():
    prep = mod(PORT, "engine.input_prep").prepare_model_input
    # 7 drafted sequences of 1+4 tokens and one plain decode row: 36 tokens,
    # T = S·(1+K) = 40 where the next power of two is 64.
    groups = [_decode(i, 20, [5, 6, 7, 8], 4 * i) for i in range(7)] + [_decode(7, 20, [], 28)]
    model_input = prep(_metadata(PORT, groups), block_size=16, max_pages_per_seq=16,
                       num_spec_tokens=4)
    assert model_input.token_ids.shape == (40,) and model_input.max_q_len == 5
    np.testing.assert_array_equal(model_input.spec_rows[7], [35] * 5)  # its row only
    np.testing.assert_array_equal(model_input.spec_rows[0], [0, 1, 2, 3, 4])
    # Without drafts the same rows take the pure-decode fast path.
    plain = prep(_metadata(PORT, [_decode(i, 20, [], 4 * i) for i in range(8)]),
                 block_size=16, max_pages_per_seq=16, num_spec_tokens=4)
    assert plain.spec_rows is None and plain.decode_only and plain.token_ids.shape == (8,)


# ------------------------------------------------------ the verify step
def _prompts():
    """Four prompts of ``tiny_trained``'s bytes."""
    texts = ["the cat sat on the mat. the cat sat on the", "abcabcabcabcabcab",
             "hello hello hello hello", "0123456789 0123456789 012"]
    return [[b + 3 for b in t.encode()] for t in texts]


def _raw(pending):
    """A dispatched step's [S, K+1] (or [S]) tokens and logprobs."""
    if hasattr(pending, "_packed"):  # the JAX worker
        packed = np.asarray(pending._packed)
    else:
        packed = pending._copies[0][0].numpy()
    n = packed.shape[0] // 2
    shape = tuple(pending._shape)
    return packed[:n].reshape(shape), packed[n:].view(np.float32).reshape(shape)


def _execute(pkg, worker, groups, *, dispatch=False):
    request = mod(pkg, "sequence").ExecuteModelRequest(
        sequence_groups_metadata=_metadata(pkg, groups))
    return worker.dispatch(request) if dispatch else worker.execute_model(request)


def test_verify_step_matches_jax_worker_and_sequential_decode():
    """Prefill four sequences in both workers, then one verify step with
    four drafts each (all, two, none and an n-gram's of the greedy
    continuation): the [S, 5] tokens and logprobs agree with JAX's within
    1e-4 and the caches after it too; each verify row's token and logprob
    is the one a decode step of the port gives at that position over the
    same tokens."""
    K = 4
    _, jworker, jparams = _jax_worker(64, 0)
    _, pworker = _port_worker(64, 0, jparams)
    for w in (jworker, pworker):
        w.scheduler_config.num_speculative_tokens = K
    prompts = _prompts()
    tables = [range(4 * i, 4 * i + 4) for i in range(4)]
    prefill = [(i, p, 0, tables[i], len(p), []) for i, p in enumerate(prompts)]
    firsts = {}
    for pkg, w in ((JAX, jworker), (PORT, pworker)):
        out = _execute(pkg, w, prefill)
        firsts[pkg] = [out[f"r{i}"].outputs[i].output_token for i in range(4)]
    assert firsts[JAX] == firsts[PORT]
    seqs = [p + [t] for p, t in zip(prompts, firsts[PORT])]
    cache0 = [c.clone() for c in pworker.cache_engine.kv_cache]

    def restore():
        for c, c0 in zip(pworker.cache_engine.kv_cache, cache0):
            c.copy_(c0)

    def decode_steps(drafts):
        """K+1 decode steps of the port, step j's input the sequence and
        ``drafts[:j]``: each step's [S] tokens and logprobs."""
        restore()
        return [_raw(_execute(PORT, pworker, [
            (i, s + d[:j], len(s) - 1 + j, tables[i], None, [])
            for i, (s, d) in enumerate(zip(seqs, drafts))], dispatch=True))
            for j in range(K + 1)]

    # The greedy continuation, fed its own tokens.
    greedy = [[] for _ in seqs]
    restore()
    for j in range(K):
        tok, _ = _raw(_execute(PORT, pworker, [
            (i, s + g, len(s) - 1 + j, tables[i], None, [])
            for i, (s, g) in enumerate(zip(seqs, greedy))], dispatch=True))
        for i, g in enumerate(greedy):
            g.append(int(tok[i]))
    wrong = [[(t + 1) % 1024 for t in g] for g in greedy]
    ngram = mod(PORT, "engine.spec_decode").NgramProposer(K).propose(seqs[3])
    drafts = [greedy[0], greedy[1][:2] + wrong[1][2:], wrong[2],
              (ngram + wrong[3])[:K]]
    restore()
    verify = [(i, s, len(s) - 1, tables[i], None, d) for i, (s, d) in enumerate(zip(seqs, drafts))]
    raws = {}
    for pkg, w in ((JAX, jworker), (PORT, pworker)):
        raws[pkg] = _raw(_execute(pkg, w, verify, dispatch=True))
    (jt, jl), (pt, pl) = raws[JAX], raws[PORT]
    assert pt.shape == (8, K + 1)
    np.testing.assert_array_equal(pt[:4], jt[:4])
    np.testing.assert_allclose(pl[:4], jl[:4], atol=LOGPROB_TOL, rtol=0)
    jcache = np.stack([np.asarray(c) for c in jworker.cache_engine.kv_cache])
    np.testing.assert_allclose(torch.stack(pworker.cache_engine.kv_cache).numpy(), jcache,
                               atol=1e-5, rtol=1e-5)
    for j, (tok, lp) in enumerate(decode_steps(drafts)):
        np.testing.assert_array_equal(tok[:4], pt[:4, j])
        np.testing.assert_allclose(lp[:4], pl[:4, j], atol=LOGPROB_TOL, rtol=0)
    accepted = [next((m for m in range(K) if pt[i, m] != drafts[i][m]), K) for i in range(4)]
    assert accepted[:3] == [K, 2, 0]


def test_acceptance_packs_the_accepted_run():
    """``PendingStep.complete``: the first mismatch ends the run; the
    accepted tokens go into ``extra_tokens``; ``num_computed_advance`` is
    1 + m; row 0's top-n keeps its place; the counters move."""
    worker_mod, seq_mod = mod(PORT, "engine.worker"), mod(PORT, "sequence")
    metrics = mod(PORT, "server.metrics")
    groups = [_decode(0, 20, [5, 6, 7], 0), _decode(1, 20, [9, 9, 9], 4), _decode(2, 20, [], 8)]
    metas = _metadata(PORT, groups)
    metas[2].top_n_tokens = 2
    tokens = torch.tensor([[5, 6, 1, 2], [8, 9, 9, 9], [4, 4, 4, 4]], dtype=torch.int32)
    logprobs = -torch.arange(12, dtype=torch.float32).reshape(3, 4) / 10
    top = (torch.arange(24, dtype=torch.int32).reshape(3, 4, 2), -torch.ones(3, 4, 2))
    packed = worker_mod._pack_outputs(tokens, logprobs)
    spec_draft = np.array([[5, 6, 7], [9, 9, 9], [-1, -1, -1]], dtype=np.int32)
    p0, a0 = metrics.SPEC_PROPOSED.value, metrics.SPEC_ACCEPTED.value
    out = worker_mod.PendingStep(metas, tokens, packed, top, 0.0, spec_draft=spec_draft,
                                 spec_k=np.array([3, 3, 0], dtype=np.int32)).complete()
    first = out["r0"].outputs[0]
    assert first.output_token == 5
    assert first.extra_tokens == [(6, pytest.approx(-0.1)), (1, pytest.approx(-0.2))]
    assert out["r0"].num_computed_advance == 3
    second = out["r1"].outputs[1]
    assert second.output_token == 8 and second.extra_tokens is None
    assert out["r1"].num_computed_advance == 1
    third = out["r2"].outputs[2]
    assert third.all_tokens == [(4, pytest.approx(-0.8))] and out["r2"].num_computed_advance is None
    assert third.top_tokens == [(16, -1.0), (17, -1.0)]  # row 0 of its [K+1, n]
    assert (metrics.SPEC_PROPOSED.value - p0, metrics.SPEC_ACCEPTED.value - a0) == (6, 2)
    assert isinstance(first, seq_mod.SequenceOutput)


# ------------------------------------------------------------- the services
@functools.lru_cache(maxsize=None)
def _built(name):
    return {"tiny_trained": _tiny_trained, "tiny_random": _tiny_random}[name]()


PROMPT = "the cat sat on the mat the cat sat on the mat the cat"
PROMPTS = [PROMPT, "abc abc abc abc abc", "one two three one two three one",
           "hello world. hello world. hello"]


def _service(pkg, name, *, k, async_scheduling=False, blocks=128, best_of=1, chunked=False,
             budget=512):
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    (jmodel, jparams, jtok), (pmodel, ptok) = _built(name)
    cfg = mod(pkg, "config")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name="injected", dtype="float32"),
        cache=cfg.CacheConfig(block_size=16, num_device_blocks_override=blocks,
                              num_host_blocks_override=64),
        scheduler=cfg.SchedulerConfig(
            max_num_batched_tokens=budget, max_num_sequences=8, max_model_len=512,
            enable_chunked_prefill=chunked, use_native_core=False,
            num_speculative_tokens=k, spec_ngram_min=1, async_scheduling=async_scheduling,
        ),
        validation=cfg.ValidationConfig(best_of=best_of, max_input_tokens=256,
                                        max_total_tokens=512),
    )
    service_mod = mod(pkg, "engine.llm_service")
    if pkg == JAX:
        return service_mod.LlmService.start(config, model=jmodel, params=jparams, tokenizer=jtok)
    return service_mod.LlmService.start(config, model=pmodel, params=params_from_numpy(jparams),
                                        tokenizer=ptok, device="cpu")


def _serve(pkg, name, requests, *, k, async_scheduling=False, late=(), proposer=None,
           watch=None, blocks=128, **service_kw):
    """Serve ``requests`` — (prompt, GenerateParameters keywords) — through
    a fresh service; those with index in ``late`` are admitted just before
    engine step 4. Returns ((tokens, text, finish reason) per request,
    metric deltas, the service). Every block must return to the pool."""
    types, metrics = mod(pkg, "types"), mod(pkg, "server.metrics")
    service = _service(pkg, name, k=k, async_scheduling=async_scheduling, blocks=blocks,
                       **service_kw)
    engine = service.engine
    if proposer is not None:
        engine.scheduler.spec_proposer = proposer
    if watch is not None:
        watch(service)
    before = {n: getattr(metrics, n).value
              for n in ("SPEC_PROPOSED", "SPEC_ACCEPTED", "PREEMPTIONS")}

    async def scenario():
        task = asyncio.create_task(engine.run())
        held = []
        engine.add_request, add = (lambda *a: held.append(a)), engine.add_request
        futs = [await service.handle_request(types.GenerateRequest(
            request_id=f"req-{i}", inputs=prompt, parameters=types.GenerateParameters(**kw)))
            for i, (prompt, kw) in enumerate(requests)]
        engine.add_request = add
        step, count = engine.step, [0]

        def counted():
            count[0] += 1
            if count[0] == 4:
                for i in late:
                    add(*held[i])
            return step()

        engine.step = counted
        for i, args in enumerate(held):
            if i not in late:
                add(*args)
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(scenario())
    free = engine.scheduler.block_manager.get_num_free_device_blocks()
    assert free == blocks, "every block returns to the pool"
    deltas = {n: getattr(metrics, n).value - v for n, v in before.items()}
    outs = [[(tuple(o.token_ids), o.output_text, o.finish_reason) for o in r.outputs]
            for r in results]
    return outs, deltas, service


GREEDY = [(p, dict(max_new_tokens=24)) for p in PROMPTS]


@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("name", ["tiny_trained", "tiny_random"])
def test_service_matches_jax_and_the_port_without_drafts(name, k, async_scheduling):
    want, jdeltas, _ = _serve(JAX, name, GREEDY, k=k, async_scheduling=async_scheduling)
    got, deltas, _ = _serve(PORT, name, GREEDY, k=k, async_scheduling=async_scheduling)
    plain, _, _ = _serve(PORT, name, GREEDY, k=0, async_scheduling=async_scheduling)
    assert got == want
    assert got == plain
    assert deltas["SPEC_PROPOSED"] > 0 and deltas["SPEC_ACCEPTED"] > 0
    assert (deltas["SPEC_PROPOSED"], deltas["SPEC_ACCEPTED"]) == \
        (jdeltas["SPEC_PROPOSED"], jdeltas["SPEC_ACCEPTED"])


class _AlwaysWrong:
    """Drafts the model (nearly) never agrees with."""

    def propose(self, token_ids, max_len=None):
        k = 3 if max_len is None else min(3, max_len)
        return [(int(t) + 1) % 100 for t in token_ids[-1:]] * k if k > 0 else []


def test_adversarial_drafts_change_nothing():
    """Wrong drafts are rejected: the tokens are JAX's under the same
    drafts and the port's without any."""
    want, _, _ = _serve(JAX, "tiny_random", GREEDY[:2], k=3, proposer=_AlwaysWrong())
    got, deltas, _ = _serve(PORT, "tiny_random", GREEDY[:2], k=3, proposer=_AlwaysWrong())
    plain, _, _ = _serve(PORT, "tiny_random", GREEDY[:2], k=0)
    assert got == want == plain
    assert deltas["SPEC_PROPOSED"] > 0


def _spy_steps(record):
    """A ``watch`` that records, per executed step, whether it carried a
    prefill chunk and drafts."""

    def watch(service):
        worker = service.engine.worker
        execute = worker.execute_model

        def spy(request):
            metas = request.sequence_groups_metadata
            record.append((any(m.is_prompt for m in metas),
                           any(m.spec_token_ids for m in metas)))
            return execute(request)

        worker.execute_model = spy

    return watch


@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_spec_mixed_with_chunked_prefill(async_scheduling):
    """A verify step also carrying another request's prefill chunk: the
    prefill's token comes from its chunk's last row; both requests match
    JAX and the port without drafts."""
    requests = [(PROMPT, dict(max_new_tokens=20)), ("z" * 200, dict(max_new_tokens=6))]
    kw = dict(chunked=True, budget=64, late=(1,), async_scheduling=async_scheduling)
    want, _, _ = _serve(JAX, "tiny_random", requests, k=4, **kw)
    steps = []
    got, deltas, _ = _serve(PORT, "tiny_random", requests, k=4, watch=_spy_steps(steps), **kw)
    plain, _, _ = _serve(PORT, "tiny_random", requests, k=0, **kw)
    assert got == want == plain
    assert (True, True) in steps, "no step carried a prefill chunk beside drafts"


def _accepted_run(name="tiny_trained", k=4):
    """A prompt of ``PROMPTS`` whose greedy output (40 tokens) has a step
    that accepted two drafts or more, after its first: (prompt, the output's
    tokens and text, the index of that step's first token)."""
    for prompt in PROMPTS:
        sizes = []

        def watch(service):
            engine = service.engine
            update = engine._update_sequence

            def spy(group, seq, seq_out):
                sizes.append(len(seq_out.all_tokens))
                return update(group, seq, seq_out)

            engine._update_sequence = spy

        outs, _, _ = _serve(PORT, name, [(prompt, dict(max_new_tokens=40))], k=k, watch=watch)
        for i, n in enumerate(sizes):
            if i > 0 and n > 2:
                return prompt, outs[0][0][0], outs[0][0][1], sum(sizes[:i])
    raise AssertionError("no prompt gives a step that accepted two drafts")


def test_max_new_tokens_cap_inside_an_accepted_run():
    """The length cap falls on the first accepted draft of a step that
    accepted two or more: the output stops there, as without drafts and in
    JAX."""
    prompt, tokens, _, at = _accepted_run()
    requests = [(prompt, dict(max_new_tokens=at + 2))]
    got, _, _ = _serve(PORT, "tiny_trained", requests, k=4)
    want, _, _ = _serve(JAX, "tiny_trained", requests, k=4)
    plain, _, _ = _serve(PORT, "tiny_trained", requests, k=0)
    assert got == want == plain
    assert got[0][0][0] == tokens[: at + 2] and got[0][0][2] == "length_capped"


def test_stop_string_inside_an_accepted_run():
    """A stop string that ends on the first accepted draft of a step that
    accepted two or more: the later tokens of the step are dropped, as
    without drafts and in JAX. (The stop string is the whole output up to
    there, so it matches nowhere earlier.)"""
    prompt, tokens, text, at = _accepted_run()
    requests = [(prompt, dict(max_new_tokens=40, stop=[text[: at + 2]]))]
    got, _, _ = _serve(PORT, "tiny_trained", requests, k=4)
    want, _, _ = _serve(JAX, "tiny_trained", requests, k=4)
    plain, _, _ = _serve(PORT, "tiny_trained", requests, k=0)
    assert got == want == plain
    assert got[0][0][0] == tokens[: at + 2] and got[0][0][2] == "stopped"


@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_seeded_sampled_request_beside_drafted_ones(async_scheduling):
    """A seeded sampled request is never drafted, but shares verify steps
    with drafted ones: its row 0 draws the noise of a step without drafts,
    so its tokens are those of the service without speculation."""
    requests = GREEDY[:3] + [(PROMPTS[3], dict(max_new_tokens=24, do_sample=True,
                                               temperature=0.9, top_p=0.95, seed=77))]
    steps = []
    got, deltas, _ = _serve(PORT, "tiny_random", requests, k=4, watch=_spy_steps(steps),
                            async_scheduling=async_scheduling)
    plain, _, _ = _serve(PORT, "tiny_random", requests, k=0, async_scheduling=async_scheduling)
    assert got == plain
    assert deltas["SPEC_ACCEPTED"] > 0 and any(drafts for _, drafts in steps)


def test_tight_pool_swaps_and_recomputes_with_drafts():
    """A pool too small for the batch: groups of two (sampled with top_k =
    1, greedy in effect, never drafted) are swapped out and back and single
    ones recomputed, while the single ones draft; tokens identical to JAX
    and to the port without drafts."""
    requests = [(p, dict(max_new_tokens=20, best_of=2, do_sample=True, top_k=1, seed=i))
                if i % 2 else (p, dict(max_new_tokens=20)) for i, p in enumerate(PROMPTS)]
    swaps = []

    def watch(service):
        ce = service.engine.worker.cache_engine
        swap_out = ce.swap_out

        def spy(mapping):
            swaps.append(len(mapping))
            return swap_out(mapping)

        ce.swap_out = spy

    kw = dict(blocks=10, best_of=2)
    want, _, _ = _serve(JAX, "tiny_random", requests, k=4, **kw)
    got, deltas, _ = _serve(PORT, "tiny_random", requests, k=4, watch=watch, **kw)
    plain, _, _ = _serve(PORT, "tiny_random", requests, k=0, **kw)
    assert got == want == plain
    assert sum(swaps) > 0 and deltas["PREEMPTIONS"] > 0 and deltas["SPEC_ACCEPTED"] > 0


def test_spec_refused_with_sliding_window_and_pipeline_parallelism():
    """Both packages refuse drafts beside a block-level sliding window
    (rejected drafts' writes could land inside the window) and beside
    pipeline parallelism."""
    for pkg in (JAX, PORT):
        cfg = mod(pkg, "config")
        sched = dict(num_speculative_tokens=2, max_num_batched_tokens=512, max_model_len=512)
        with pytest.raises(ValueError, match="sliding window"):
            cfg.EngineConfig(model=cfg.ModelConfig(model_name="m"),
                             cache=cfg.CacheConfig(block_size=16, sliding_window=64),
                             scheduler=cfg.SchedulerConfig(**sched),
                             validation=cfg.ValidationConfig())
        with pytest.raises(ValueError, match="pipeline"):
            cfg.EngineConfig(model=cfg.ModelConfig(model_name="m", pipeline_parallel_size=2),
                             cache=cfg.CacheConfig(block_size=16),
                             scheduler=cfg.SchedulerConfig(**sched),
                             validation=cfg.ValidationConfig())


# ------------------------------------------------------- CUDA-graph keys
def _key(groups, *, k=4, feed=False, top_n=0, **params):
    from atoma_infer_tpu_torch.engine.cuda_graphs import step_graph_key
    from atoma_infer_tpu_torch.engine.sampler import SamplingTensors

    metas = _metadata(PORT, groups, **params)
    model_input = mod(PORT, "engine.input_prep").prepare_model_input(
        metas, block_size=16, max_pages_per_seq=16, num_spec_tokens=k)
    ps = [m.next_token_chooser_params for m in metas]
    sampling = SamplingTensors.build(ps, [[] for _ in ps], model_input.seq_lens.shape[0],
                                     [top_n] * len(ps))
    return step_graph_key(model_input, sampling, feed)


def test_verify_steps_have_keys_of_their_own():
    drafted = [_decode(i, 20, [5, 6, 7, 8], 4 * i) for i in range(3)]
    # T = S·(1+K) = 40 (12 tokens: bucket 16 ≤ 40, so the power of two).
    assert _key(drafted) == (16, 8, 8, 5, False, False, 0, True)
    full = [_decode(i, 20, [5, 6, 7, 8], 4 * i) for i in range(7)] + [_decode(7, 20, [], 28)]
    assert _key(full) == (40, 8, 8, 5, False, False, 0, True)
    # One short draft: max_q_len is still 1+K.
    assert _key([_decode(0, 20, [5], 0)], k=3) == (8, 8, 8, 4, False, False, 0, True)
    # Drafted rows beside a seeded sampled row asking for top-n.
    assert _key(drafted, top_n=2, do_sample=True, temperature=0.7, seed=1) == \
        (16, 8, 8, 5, True, False, 2, True)
    # The same rows without drafts: the pure-decode key.
    assert _key([_decode(i, 20, [], 4 * i) for i in range(3)]) == \
        (8, 8, 8, False, False, 0, False)


@pytest.mark.parametrize("groups, params, key", [
    # A 37-token prefill chunk beside: 37 + 3 tokens, T = S·(1+K) = 40;
    # max_q_len the chunk's bucket 64 capped at T, not 1+K.
    ([(10, list(range(3, 40)), 0, range(20, 23), 37, [])]
     + [_decode(0, 20, [5, 6], 0)], {}, (40, 8, 8, False, False, False, False, 0, 5, False, 40)),
    # Penalties: the verify layout, max_q_len 1+K.
    ([_decode(0, 20, [5, 6], 0)], dict(repetition_penalty=1.2),
     (8, 8, 8, False, False, True, False, 0, 5, False, 5)),
    ([_decode(0, 20, [5, 6], 0)], dict(frequency_penalty=0.5),
     (8, 8, 8, False, False, True, False, 0, 5, False, 5)),
], ids=["mixed", "repetition_penalty", "frequency_penalty"])
def test_verify_steps_without_a_graph(groups, params, key):
    """The verify steps that ran eagerly before every step had a graph:
    each now has a general key, with the verify rows' width 1+K."""
    from atoma_infer_tpu_torch.engine.cuda_graphs import StepKey

    got = _key(groups, **params)
    assert got == key and type(got) is StepKey


def test_verify_step_with_a_feed_is_refused():
    with pytest.raises(ValueError, match="synchronously"):
        _key([_decode(0, 20, [5, 6], 0)], feed=True)


def test_static_inputs_and_reserve_fit_the_widest_verify_key():
    from atoma_infer_tpu_torch.config import SchedulerConfig
    from atoma_infer_tpu_torch.engine.cuda_graphs import (
        MAX_GRAPHS, StepGraphs, packed_capacity, token_capacity,
    )
    from atoma_infer_tpu_torch.engine.llm_service import (
        GRAPH_BYTES_PER_LAYER, GRAPH_POOL_ROWS, PENALTY_POOL_ROWS, activation_bytes,
        graph_reserve_bytes, split_workspace_bytes,
    )
    from atoma_infer_tpu_torch.engine.sampler import PENALTY_WINDOW
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    # K = 0 keeps the pure-decode sizes.
    assert packed_capacity(64, 128, 64, 0) == packed_capacity(64, 128, 64) == \
        8 * 64 + 64 * 128 + 2
    for S, P, K in ((8, 128, 4), (64, 128, 3), (16, 8, 1)):
        rows = S * (1 + K)
        # A verify step at T = S·(1+K), within the budget's bucket: tokens,
        # positions, slots, tables, lengths, query starts, sampling steps,
        # the count, the verify rows.
        verify = 3 * rows + S * P + S + (S + 1) + S + 1 + rows
        assert verify <= packed_capacity(S, P, token_capacity(rows), K)
        # A decode step with the feed fits too.
        assert 4 * S + S * P + 4 * S + 2 <= packed_capacity(S, P, token_capacity(rows), K)
    # The reserve: R = S·(1+K) rows of noise and of every pool buffer.
    S, K, V = 8, 4, 128256
    cfg = LlamaConfig(vocab_size=V, num_hidden_layers=16)

    def sched(k):
        return SchedulerConfig(max_num_batched_tokens=256, max_num_sequences=S,
                               max_model_len=2048, enable_chunked_prefill=True,
                               num_speculative_tokens=k)

    static = 40 * V + packed_capacity(8, 128, 256, 4) + 8 * (8 + PENALTY_WINDOW)
    forward = activation_bytes(256, cfg) + split_workspace_bytes(256, cfg, 128, 16)
    assert graph_reserve_bytes(cfg, sched(4), 16) == (
        4 * (static + (GRAPH_POOL_ROWS + PENALTY_POOL_ROWS) * 40 * V) + forward
        + (MAX_GRAPHS + 1) * 16 * GRAPH_BYTES_PER_LAYER)
    assert graph_reserve_bytes(cfg, sched(4), 16) > graph_reserve_bytes(cfg, sched(0), 16)
    graphs = StepGraphs(max_rows=8, max_pages=128, max_tokens=256, num_spec_tokens=4)
    assert graphs.packed_capacity == packed_capacity(8, 128, 256, 4)


def test_service_with_stub_graphs_replays_verify_steps(monkeypatch):
    """The card's path on the CPU: a worker with graphs whose capture is a
    stub that replays by recomputing the captured step into its outputs.
    Verify steps and decode steps replay; the tokens are those of the eager
    service; every verify step after its key's first is a replay."""
    from atoma_infer_tpu_torch.engine import cuda_graphs, worker as worker_mod

    class Replay:
        def __init__(self, step, views, outputs):
            self.step, self.views, self.outputs = step, views, outputs

        @torch.inference_mode()
        def replay(self):
            new = self.step(*self.views)
            for old, fresh in zip(self.outputs[:3], new[:3]):
                old.copy_(fresh)
            if self.outputs[3] is not None:
                for old, fresh in zip(self.outputs[3], new[3]):
                    old.copy_(fresh)

    def capture(self, step, views):
        outputs = step(*views)
        return cuda_graphs._Graph(Replay(step, views, outputs), views, outputs, {})

    monkeypatch.setattr(cuda_graphs.StepGraphs, "_capture", capture)
    # On the CPU the host copy is the tensor itself, which a later replay of
    # the same graph overwrites; the card copies to pinned memory.
    monkeypatch.setattr(worker_mod, "_to_host", lambda t: (t.clone(), None))
    verify_keys = []

    def watch(service):
        worker = service.engine.worker
        cfg = service.config
        worker.graphs = cuda_graphs.StepGraphs(
            8, cuda_graphs.page_capacity(cfg.scheduler.max_model_len, cfg.cache.block_size),
            cuda_graphs.token_capacity(cfg.scheduler.max_num_batched_tokens),
            cfg.scheduler.num_speculative_tokens)
        run = worker.graphs.run

        def spy(key, *args):
            if isinstance(key, cuda_graphs.VerifyKey):
                verify_keys.append((key, key in worker.graphs.graphs))
            return run(key, *args)

        worker.graphs.run = spy

    requests = GREEDY[:3] + [(PROMPTS[3], dict(max_new_tokens=24, do_sample=True,
                                               temperature=0.9, seed=5))]
    for async_scheduling in (False, True):
        verify_keys.clear()
        got, _, service = _serve(PORT, "tiny_random", requests, k=4, watch=watch,
                                 async_scheduling=async_scheduling)
        eager, _, _ = _serve(PORT, "tiny_random", requests, k=4,
                             async_scheduling=async_scheduling)
        assert got == eager
        graphs = service.engine.worker.graphs
        replayed = [seen for _, seen in verify_keys]
        assert sum(replayed) > 0 and graphs.replays > sum(replayed)
        # A key's first step is its capture; every later one replays.
        first = {}
        for key, seen in verify_keys:
            assert seen == (key in first)
            first[key] = True
