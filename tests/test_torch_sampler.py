"""The port's sampler vs the JAX sampler on identical logits.

Greedy choice, logprobs, top-n and the top-k / top-p / typical masks must
agree with JAX (masks exactly; logprobs to atol 1e-6, f32 log-softmax in
another summation order). The random stream is an intended divergence: JAX
draws threefry Gumbel noise, the port a ``torch.Generator`` per row — so
sampled draws are held to the contract instead: deterministic per
(seed, step), stable on replay, and always inside the filtered set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu.engine import sampler as jax_sampler
from atoma_infer_tpu_torch.engine import sampler
from atoma_infer_tpu_torch.sampling_params import NextTokenChooserParameters

torch.set_num_threads(2)


def _tensors(params, S, recent=None, top_n=0):
    recent = recent or [[] for _ in range(S)]
    return sampler.SamplingTensors.build(params, recent, S, [top_n] * S)


def _jax_sample(logits, t):
    S = logits.shape[0]
    return jax_sampler.sample(
        jnp.asarray(logits),
        temperature=jnp.asarray(t.temperature), top_k=jnp.asarray(t.top_k),
        top_p=jnp.asarray(t.top_p), typical_p=jnp.asarray(t.typical_p),
        do_sample=jnp.asarray(t.do_sample), seeds=jnp.asarray(t.seeds),
        repetition_penalty=jnp.asarray(t.repetition_penalty),
        frequency_penalty=jnp.asarray(t.frequency_penalty),
        recent_tokens=jnp.asarray(t.recent_tokens), step=jnp.zeros((S,), jnp.int32),
        needs_sampling=t.needs_sampling, needs_penalties=t.needs_penalties,
        needs_typical=t.needs_typical, top_n=t.top_n,
    )


def _torch_sample(logits, t, steps=None):
    S, V = logits.shape
    arrays = t.to_device("cpu", np.ones(S, bool))
    gumbel = None
    if t.needs_sampling:
        steps = np.zeros(S, np.int32) if steps is None else steps
        gumbel = sampler.gumbel_noise(t.seeds, steps, np.nonzero(t.do_sample)[0], V, "cpu")
    return sampler.sample(
        torch.from_numpy(logits), gumbel=gumbel, needs_penalties=t.needs_penalties,
        needs_typical=t.needs_typical, top_n=t.top_n,
        **{k: v for k, v in arrays.items()},
    )


@pytest.mark.parametrize("penalties", [False, True])
def test_greedy_tokens_logprobs_topn_match_jax(penalties):
    rng = np.random.default_rng(0)
    S, V = 6, 300
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    params = [
        NextTokenChooserParameters(
            repetition_penalty=1.3 if penalties else 1.0,
            frequency_penalty=0.4 if penalties else 0.0,
        )
        for _ in range(S)
    ]
    recent = [list(rng.integers(0, V, size=20)) for _ in range(S)]
    t = _tensors(params, S, recent, top_n=4)
    assert t.needs_penalties == penalties and not t.needs_sampling
    tok_j, lp_j, (ids_j, lps_j) = _jax_sample(logits, t)
    tok_t, lp_t, (ids_t, lps_t) = _torch_sample(logits, t)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-6)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lps_t.numpy(), np.asarray(lps_j), atol=1e-6)


def test_penalties_match_jax():
    rng = np.random.default_rng(1)
    S, V = 4, 50
    logits = rng.standard_normal((S, V)).astype(np.float32)
    recent = np.full((S, sampler.PENALTY_WINDOW), -1, np.int32)
    recent[:, :30] = rng.integers(0, V, size=(S, 30))
    rp = np.asarray([1.0, 1.2, 0.8, 2.0], np.float32)
    fp = np.asarray([0.0, 0.5, 0.1, 1.0], np.float32)
    want = jax_sampler.apply_penalties(
        jnp.asarray(logits), jnp.asarray(recent), jnp.asarray(rp), jnp.asarray(fp)
    )
    got = sampler.apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(recent), torch.from_numpy(rp), torch.from_numpy(fp)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mask", ["top_k", "top_p", "typical_p"])
def test_masks_match_jax(mask):
    rng = np.random.default_rng(2)
    S, V = 5, 200
    logits = (rng.standard_normal((S, V)) * 2).astype(np.float32)
    if mask == "top_k":
        k = np.asarray([0, 1, 5, 40, 128], np.int32)
        want = jax_sampler._top_k_mask(jnp.asarray(logits), jnp.asarray(k), 128)
        got = sampler._top_k_mask(torch.from_numpy(logits), torch.from_numpy(k), 128)
    elif mask == "top_p":
        p = np.asarray([1.0, 0.1, 0.5, 0.9, 0.99], np.float32)
        want = jax_sampler._top_p_mask(jnp.asarray(logits), jnp.asarray(p))
        got = sampler._top_p_mask(torch.from_numpy(logits), torch.from_numpy(p))
    else:
        p = np.asarray([1.0, 0.2, 0.5, 0.8, 0.95], np.float32)
        want = jax_sampler._typical_p_mask(jnp.asarray(logits), jnp.asarray(p))
        got = sampler._typical_p_mask(torch.from_numpy(logits), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_draws_deterministic_per_seed_and_step():
    rng = np.random.default_rng(4)
    S, V = 4, 256
    logits = (rng.standard_normal((S, V)) * 1.5).astype(np.float32)
    params = [
        NextTokenChooserParameters(do_sample=True, temperature=0.9, top_k=50, top_p=0.95, seed=7 + i)
        for i in range(S)
    ]
    t = _tensors(params, S)
    assert t.needs_sampling
    masked = sampler._top_p_mask(
        sampler._top_k_mask(torch.from_numpy(logits) / 0.9, torch.from_numpy(t.top_k), 128),
        torch.from_numpy(t.top_p),
    )

    draws = {}
    for step in range(12):
        steps = np.full(S, step, np.int32)
        a = _torch_sample(logits, t, steps)[0].numpy()
        b = _torch_sample(logits, t, steps)[0].numpy()   # replay
        np.testing.assert_array_equal(a, b)
        for i, tok in enumerate(a):
            assert torch.isfinite(masked[i, tok])
        draws[step] = a
    # Different steps give different draws (not a constant stream).
    assert len({tuple(d) for d in draws.values()}) > 1
    # A row's draw depends only on its own (seed, step), not on its batch.
    solo = _tensors(params[2:3], 1)
    one = _torch_sample(logits[2:3], solo, np.asarray([5], np.int32))[0].numpy()
    assert one[0] == draws[5][2]


def test_gumbel_draws_follow_the_distribution():
    """Gumbel-max over 2000 (seed, step) draws reproduces softmax(logits)."""
    V = 8
    logits = np.log(np.asarray([0.4, 0.2, 0.1, 0.1, 0.1, 0.05, 0.03, 0.02], np.float32))
    n = 2000
    noise = sampler.gumbel_noise(
        np.full(n, 3, np.uint32), np.arange(n), np.arange(n), V, "cpu"
    )
    draws = torch.argmax(torch.from_numpy(logits)[None] + noise, dim=-1).numpy()
    freq = np.bincount(draws, minlength=V) / n
    np.testing.assert_allclose(freq, np.exp(logits), atol=0.035)
