"""The port's Llama vs the JAX Llama on identical weights and inputs.

Weights: ``tests/fixtures/tiny_trained`` (f32), loaded by the JAX package and
carried across with ``params_from_numpy``. Tolerances (f32 throughout):
- logits atol/rtol 1e-4: the same f32 arithmetic in another order (XLA vs
  PyTorch CPU matmuls) over 4 layers;
- post-step KV caches atol 1e-5: K/V rows are one projection + rope away
  from identical inputs.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu.models.llama import Llama as JaxLlama
from atoma_infer_tpu.models.registry import get_model_cls as jax_get_model_cls
from atoma_infer_tpu.models.registry import list_models as jax_list_models
from atoma_infer_tpu.models.weights import load_hf_config as jax_load_hf_config
from atoma_infer_tpu.models.weights import load_llama_params as jax_load_llama_params
from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig
from atoma_infer_tpu_torch.models.registry import get_model_cls
from atoma_infer_tpu_torch.models.weights import (
    load_hf_config,
    load_llama_params,
    params_from_numpy,
)

from torch_parity import jax_meta, torch_meta

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_trained")
BLOCK_SIZE = 16
NUM_BLOCKS = 16


@pytest.fixture(scope="module")
def models():
    jcfg = jax_load_hf_config(FIXTURE)
    jmodel = JaxLlama(jcfg, dtype=jnp.float32)
    jparams = jax_load_llama_params(FIXTURE, jcfg, dtype=jnp.float32)
    cfg = load_hf_config(FIXTURE)
    model = Llama(cfg, dtype=torch.float32, device="cpu")
    params = params_from_numpy(jparams)
    return jmodel, jparams, model, params


def _step_meta(seq_lens, q_lens, tables, decode_only=False):
    """Metadata arrays (numpy) for sequences with kv lengths ``seq_lens``
    whose last ``q_lens`` tokens are this step's queries."""
    S = len(seq_lens)
    T = -(-sum(q_lens) // 8) * 8
    P = max(len(t) for t in tables)
    bt = np.zeros((S, P), np.int32)
    qsl = np.zeros(S + 1, np.int32)
    slots = np.full(T, -1, np.int32)
    positions = np.zeros(T, np.int32)
    for s, (kv, q, t) in enumerate(zip(seq_lens, q_lens, tables)):
        bt[s, : len(t)] = t
        qsl[s + 1] = qsl[s] + q
        for i in range(q):
            pos = kv - q + i
            slots[qsl[s] + i] = t[pos // BLOCK_SIZE] * BLOCK_SIZE + pos % BLOCK_SIZE
            positions[qsl[s] + i] = pos
    case = dict(
        block_tables=bt, seq_lens=np.asarray(seq_lens, np.int32), query_start_loc=qsl,
        slot_mapping=slots, num_seqs=S, block_size=BLOCK_SIZE,
        max_q_len=max(q_lens), decode_only=decode_only,
    )
    return case, positions


def _run_both(models, steps, token_stream):
    """Run a list of steps (seq_lens, q_lens) through both models on shared
    tables; return per-step (jax logits, torch logits) at every token row,
    and the final caches."""
    jmodel, jparams, model, params = models
    tables = [[3, 9, 1], [12, 0, 7]]
    jcache = jnp.zeros(jmodel.kv_cache_shape(NUM_BLOCKS, BLOCK_SIZE), jnp.float32)
    tcache = model.alloc_kv_cache(NUM_BLOCKS, BLOCK_SIZE)
    results = []
    for seq_lens, q_lens in steps:
        decode_only = all(q == 1 for q in q_lens)
        case, positions = _step_meta(seq_lens, q_lens, tables[: len(seq_lens)], decode_only)
        T = positions.shape[0]
        toks = np.zeros(T, np.int32)
        row = 0
        for s, (kv, q) in enumerate(zip(seq_lens, q_lens)):
            toks[row: row + q] = token_stream[s][kv - q: kv]
            row += q
        hidden_j, jcache = jmodel.forward(
            jparams, jnp.asarray(toks), jnp.asarray(positions), jcache, jax_meta(case)
        )
        logits_j = np.asarray(jmodel.compute_logits(jparams, hidden_j))
        hidden_t = model.forward(
            params, torch.from_numpy(toks), torch.from_numpy(positions), tcache, torch_meta(case)
        )
        logits_t = model.compute_logits(params, hidden_t).numpy()
        n = int(case["query_start_loc"][-1])
        results.append((logits_j[:n], logits_t[:n]))
    return results, np.asarray(jcache), torch.stack(tcache).numpy()


def test_config_and_weights_match_jax(models):
    jmodel, jparams, model, params = models
    jcfg = dataclasses.asdict(jmodel.config)
    cfg = dataclasses.asdict(model.config)
    assert cfg == jcfg
    own = load_llama_params(FIXTURE, model.config, dtype=torch.float32, device="cpu")
    assert own.keys() == params.keys() and own["layers"].keys() == params["layers"].keys()
    for key in params["layers"]:
        assert torch.equal(own["layers"][key], params["layers"][key]), key
    assert torch.equal(own["embed"], params["embed"])
    assert get_model_cls("LlamaForCausalLM") is Llama
    # Every family the JAX package registers resolves to the port's class.
    for name in jax_list_models():
        cls = get_model_cls(name)
        assert cls.__module__.startswith("atoma_infer_tpu_torch.models.")
        assert cls.__name__ == jax_get_model_cls(name).__name__


def test_logits_match_jax_prefill_then_decode(models):
    rng = np.random.default_rng(0)
    stream = [rng.integers(2, 1024, size=48).astype(np.int32) for _ in range(2)]
    steps = [
        ((21, 30), (21, 30)),   # two prefills
        ((22, 31), (1, 1)),     # pure decode
        ((40, 32), (18, 1)),    # chunk continuation + decode (mixed)
        ((41, 33), (1, 1)),
    ]
    results, jcache, tcache = _run_both(models, steps, stream)
    for logits_j, logits_t in results:
        np.testing.assert_allclose(logits_t, logits_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache, jcache, atol=1e-5, rtol=1e-5)


def test_prefill_equals_token_by_token_decode(models):
    _, _, model, params = models
    T = 13
    tokens = np.random.RandomState(1).randint(0, 1024, size=T).astype(np.int32)
    tables = [[2, 6]]

    def forward(cache, seq_len, q_len):
        case, positions = _step_meta([seq_len], [q_len], tables, decode_only=q_len == 1)
        toks = np.zeros(positions.shape[0], np.int32)
        toks[:q_len] = tokens[seq_len - q_len: seq_len]
        hidden = model.forward(
            params, torch.from_numpy(toks), torch.from_numpy(positions), cache, torch_meta(case)
        )
        return model.compute_logits(params, hidden[:q_len])

    full = forward(model.alloc_kv_cache(8, BLOCK_SIZE), T, T)
    cache = model.alloc_kv_cache(8, BLOCK_SIZE)
    forward(cache, 5, 5)
    for t in range(6, T + 1):
        last = forward(cache, t, 1)
    np.testing.assert_allclose(last[0].numpy(), full[-1].numpy(), atol=2e-4, rtol=2e-4)


def test_model_constructor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(LlamaConfig(num_hidden_layers=1, max_position_embeddings=16))
