"""The port's parallelism layer against the JAX package's.

- ``shard_params``: rank r's slices equal, byte for byte, the r-th
  addressable shard of the JAX arrays placed by ``param_shardings`` over a
  mesh of the conftest's virtual CPU devices — dense, INT8, INT4, qkv
  biases, tied and untied (dense and INT8) LM heads, Mixtral's experts split
  whole (expert parallelism) and by their intermediate dim, and the kv heads
  copied when tp is wider than them (there JAX places the repeated heads);
  a row-parallel quantized slice must be whole groups; the loader cuts the
  same slices layer by layer.
- Payloads: ``encode_payload`` gives JAX's bytes; the broadcast roundtrips
  in its one-phase small bucket and its two-phase large one; every
  collective of ``TpGroup`` across two spawned gloo ranks.
- The INT8 write and the fused decode with ``scales_new`` (a rank's heads,
  the full-head scales) equal the full-head computation on those heads.
- The lockstep (mirroring ``tests/test_multihost_procs.py``): two ranks'
  schedule traces are equal, an abort lands in the same step on both, and
  both finish with the same outputs.
- Mixtral at tp = 2, with and without expert parallelism: logits within
  1e-4 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tpar
from torch_parity import model_step, to_numpy, torch_meta

torch.set_num_threads(2)

LLAMA = dict(
    vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=4, head_dim=32,
    max_position_embeddings=128, tie_word_embeddings=True, eos_token_ids=(1,),
    bos_token_id=0, rope_scaling=None,
)
MIXTRAL = dict(LLAMA, intermediate_size=96, num_local_experts=4, num_experts_per_tok=2)


def _jax_model(widths, family):
    if family == "mixtral":
        from atoma_infer_tpu.models.mixtral import Mixtral, MixtralConfig

        return Mixtral(MixtralConfig(**widths), dtype=jnp.float32)
    from atoma_infer_tpu.models.llama import Llama, LlamaConfig

    return Llama(LlamaConfig(**widths), dtype=jnp.float32)


def _jax_quantized(port_q):
    """A port ``QuantizedTensor`` → the JAX package's, same bytes."""
    from atoma_infer_tpu.ops.quant import QuantizedTensor as JaxQ

    return JaxQ(qweight=jnp.asarray(port_q.qweight.numpy()),
                scales=jnp.asarray(to_numpy(port_q.scales)),
                bits=port_q.bits, group_size=port_q.group_size)


def _trees(case):
    """(JAX params, port params, num_kv_heads, tp) of one sharding case."""
    from atoma_infer_tpu_torch.models.weights import params_from_numpy, quantize_params
    from atoma_infer_tpu_torch.ops.quant import QuantizedTensor

    family, widths, quant, tp = CASES[case]
    jparams = _jax_model(widths, family).init_params(jax.random.PRNGKey(1))
    port = params_from_numpy(jparams)
    if quant:
        port = quantize_params(port, quant)
        jparams = dict(jparams, layers=dict(jparams["layers"]))
        for key, value in port["layers"].items():
            if isinstance(value, QuantizedTensor):
                jparams["layers"][key] = _jax_quantized(value)
        if "lm_head" in port:
            jparams["lm_head"] = _jax_quantized(port["lm_head"])
    return jparams, port, widths["num_key_value_heads"], tp


CASES = {
    # name: (family, widths, quantization, tp)
    "dense-tp2": ("llama", LLAMA, None, 2),
    "dense-tp4": ("llama", LLAMA, None, 4),
    "int8": ("llama", dict(LLAMA, tie_word_embeddings=False), "int8", 2),
    "int4": ("llama", LLAMA, "int4", 2),
    "qkv-bias": ("llama", dict(LLAMA, attention_bias=True), None, 2),
    "untied-dense": ("llama", dict(LLAMA, tie_word_embeddings=False), None, 4),
    "mixtral-expert-parallel": ("mixtral", MIXTRAL, None, 2),
    "mixtral-intermediate-split": ("mixtral", dict(MIXTRAL, num_local_experts=3), None, 2),
    "kv-repeat": ("llama", dict(LLAMA, num_key_value_heads=2), None, 4),
}


def _leaves(tree, prefix=""):
    """{path: numpy array} of a parameter tree (JAX or port), quantized
    weights as their qweight and scales."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_leaves(value, path + "/"))
        elif hasattr(value, "qweight"):
            out[path + ".qweight"] = value.qweight
            out[path + ".scales"] = value.scales
        else:
            out[path] = value
    return out


class _Rank:
    def __init__(self, tp, rank):
        self.tp, self.rank = tp, rank


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_params_match_jax_shards(case):
    from atoma_infer_tpu.parallel import make_mesh, shard_params as jax_shard
    from atoma_infer_tpu_torch.parallel.sharding import shard_params

    jparams, port, hk, tp = _trees(case)
    devices = jax.devices()[:tp]
    rep = max(1, tp // hk)
    if rep > 1:
        # JAX shards k/v by columns and repeats the heads after the matmul;
        # the weights whose columns ARE the repeated heads, placed by the
        # same rule, are what each JAX shard attends with.
        layers = dict(jparams["layers"])
        for key in ("k_proj", "v_proj"):
            w = layers[key]
            L, H, n = w.shape
            layers[key] = jnp.repeat(w.reshape(L, H, hk, n // hk), rep, axis=2).reshape(
                L, H, n * rep)
        jparams = dict(jparams, layers=layers)
    placed = _leaves(jax_shard(make_mesh(tp=tp, devices=devices), jparams))
    for rank in range(tp):
        mine = _leaves(shard_params(
            {**port, "layers": dict(port["layers"])}, _Rank(tp, rank), hk))
        assert mine.keys() == placed.keys()
        for path, arr in placed.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[rank])
            want = np.asarray(shard.data)
            got = to_numpy(mine[path])
            assert got.shape == want.shape, (path, rank)
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (path, rank)


def test_row_parallel_quantized_slice_must_be_whole_groups():
    """o_proj and down_proj hold 2 groups of 128 rows: 2 ranks take one
    each; 4 ranks would cut a group."""
    from atoma_infer_tpu_torch.parallel.sharding import shard_params

    _, port, hk, _ = _trees("int8")
    shard_params({**port, "layers": dict(port["layers"])}, _Rank(2, 1), hk)
    with pytest.raises(ValueError, match="whole groups"):
        shard_params({**port, "layers": dict(port["layers"])}, _Rank(4, 0), hk)


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_loader_cuts_the_same_slices_layer_by_layer(quantization, tmp_path):
    """``load_llama_params(group=…)`` from an HF-layout checkpoint equals
    ``shard_params`` of the whole load."""
    from safetensors.torch import save_file

    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.models.weights import load_llama_params
    from atoma_infer_tpu_torch.parallel.sharding import shard_params

    cfg = LlamaConfig(**dict(LLAMA, tie_word_embeddings=False, num_key_value_heads=2))
    _, port, _, _ = _trees("untied-dense")
    g = torch.Generator().manual_seed(0)
    tensors = {"model.embed_tokens.weight": port["embed"],
               "model.norm.weight": port["final_norm"],
               "lm_head.weight": port["lm_head"].t().contiguous()}
    names = {"q_proj": "self_attn.q_proj", "o_proj": "self_attn.o_proj",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj", "down_proj": "mlp.down_proj"}
    for i in range(cfg.num_layers):
        tensors[f"model.layers.{i}.input_layernorm.weight"] = port["layers"]["input_norm"][i]
        tensors[f"model.layers.{i}.post_attention_layernorm.weight"] = port["layers"]["post_norm"][i]
        for key, name in names.items():
            tensors[f"model.layers.{i}.{name}.weight"] = port["layers"][key][i].t().contiguous()
        for key in ("k_proj", "v_proj"):
            tensors[f"model.layers.{i}.self_attn.{key}.weight"] = torch.randn(
                2 * 32, 128, generator=g)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    whole = load_llama_params(str(tmp_path), cfg, dtype=torch.float32, device="cpu",
                              quantization=quantization)
    # INT8 at 2 ranks only: o_proj's 2 groups of 128 rows do not divide over 4.
    for tp in (2,) if quantization else (2, 4):
        for rank in range(tp):
            got = _leaves(load_llama_params(str(tmp_path), cfg, dtype=torch.float32,
                                            device="cpu", quantization=quantization,
                                            group=_Rank(tp, rank)))
            want = _leaves(shard_params({**whole, "layers": dict(whole["layers"])},
                                        _Rank(tp, rank), cfg.num_kv_heads))
            assert got.keys() == want.keys()
            for path in want:
                assert torch.equal(got[path], want[path]), (path, tp, rank)


def test_encode_payload_bytes_and_serialized_groups_match_jax():
    """The same admissions serialize to the same dicts and the same bucket
    bytes in both packages; small, mid and large payloads land in JAX's
    buckets (1 KiB, 16 KiB, 256 KiB)."""
    from atoma_infer_tpu.engine import multihost as jax_mh
    from atoma_infer_tpu.parallel import distributed as jax_dist
    from atoma_infer_tpu_torch.engine import multihost
    from atoma_infer_tpu_torch.parallel import distributed

    from test_torch_engine import make_group

    rng = np.random.default_rng(0)
    buckets = set()
    for n_tokens in (20, 600, 15000):
        prompt = rng.integers(3, 100000, size=n_tokens).tolist()
        payloads = []
        for pkg, mh in (("atoma_infer_tpu", jax_mh), ("atoma_infer_tpu_torch", multihost)):
            groups = [make_group(pkg, f"r{i}", prompt, max_new_tokens=7, seq_ids=[10 * i, 10 * i + 1],
                                 do_sample=True, top_k=3, seed=i) for i in range(2)]
            payloads.append({"admit": [mh.serialize_group(g) for g in groups],
                             "aborts": ["x"], "stop": False})
        assert payloads[0] == payloads[1]
        jbuf = jax_dist.encode_payload(payloads[0])
        buf = distributed.encode_payload(payloads[1])
        assert buf.shape == jbuf.shape and np.array_equal(buf, jbuf)
        buckets.add(buf.shape[0])
        assert distributed.decode_payload(buf) == payloads[0]
        back = multihost.serialize_group(
            multihost.deserialize_group(payloads[1]["admit"][1], 16))
        assert back == payloads[1]["admit"][1]
    assert buckets == {1 << 10, 1 << 14, 1 << 18}


def test_collectives_and_both_broadcast_phases_across_two_ranks(tmp_path):
    small = {"admit": [], "aborts": [], "stop": False}
    large = {"ids": np.random.default_rng(1).integers(0, 1 << 30, size=5000).tolist()}
    results = tpar.spawn_ranks(tpar.collectives_rank, 2, tmp_path, [small, large])
    for got in results:
        assert got["sum"] == [[3.0, 3.0]] * 3
        assert got["max"] == [[1.0, 0.0]]
        assert got["gather"] == [[0.0, 1.0]] * 2
        assert got["min"] == 10
        assert got["payloads"] == [small, large]
        # 3 tensor collectives, one small broadcast and a large one's two.
        assert got["collectives"] == 6


def test_a_one_rank_group_runs_every_collective(tmp_path):
    """One gloo rank in this process: every collective runs and returns its
    input (the smoke runs the same on one card over NCCL)."""
    from atoma_infer_tpu_torch.parallel.distributed import broadcast_step_payload
    from atoma_infer_tpu_torch.parallel.group import TpGroup

    group = TpGroup.join(tp=1, rank=0, device="cpu", backend="gloo", stage_on_host=False,
                         init_method=tpar.rendezvous_file(tmp_path))
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    assert torch.equal(group.all_reduce_sum(x.clone()), x)
    assert torch.equal(group.all_reduce_max(x.clone()), x)
    assert torch.equal(group.all_gather_last(x), x)
    assert group.min_int(7) == 7
    group.barrier()
    assert group.broadcast_bytes(np.arange(5, dtype=np.uint8), 5).tolist() == [0, 1, 2, 3, 4]
    assert broadcast_step_payload(group, {"a": 1}) == {"a": 1}  # one rank: no traffic
    assert group.collectives == 4


def test_backend_from_the_layout():
    from atoma_infer_tpu_torch.parallel.group import choose_backend, device_share, local_device

    assert choose_backend("cpu", 4, 1) == ("gloo", False)
    assert choose_backend("cuda", 2, 8) == ("nccl", False)
    assert choose_backend("cuda", 2, 1) == ("gloo", True)
    assert [local_device("cuda", i, 2).index for i in range(4)] == [0, 1, 0, 1]
    assert [device_share("cuda", i, 4, 2) for i in range(4)] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert device_share("cuda", 1, 2, 8) == (0, 1) and device_share("cpu", 3, 4, 1) == (0, 1)


# ------------------------------------------------------- INT8 scales_new
def _rank_heads(case, lo, hi):
    """The case's new K/V restricted to kv heads [lo, hi), and its cache
    rows restricted to them."""
    D = case["k_new"].shape[2]
    return (case["k_new"][:, lo:hi], case["v_new"][:, lo:hi],
            case["kv_cache"][..., 2 * D * lo: 2 * D * hi])


@pytest.mark.parametrize("fused", [False, True], ids=["write", "fused-decode"])
def test_scales_new_equals_the_full_head_computation(fused):
    """A rank's two kv heads of four, given the full-head scales: its cache
    rows and scales equal those heads' slice of the full-head write, and
    the fused decode's attention equals the full computation's on its q
    heads."""
    from atoma_infer_tpu_torch.ops.kv_cache import kv_quant_scales
    from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_quant_plain
    from atoma_infer_tpu_torch.ops.paged_attention import fused_decode_attention_plain

    rng = np.random.default_rng(3)
    specs = [(1, 40), (1, 17), (1, 5)] if fused else [(9, 40), (1, 17), (5, 5)]
    case = tpar.quantized_case(rng, specs, "int8", num_q_heads=8, num_kv_heads=4, head_dim=16)
    case["k_new"][:, :2] *= 4.0  # the other heads hold the absmax: local scales would differ
    meta = torch_meta(case)
    t = {k: torch.from_numpy(np.asarray(case[k])) for k in ("q", "k_new", "v_new")}
    full_cache = torch.from_numpy(case["kv_cache"].copy())
    full_scales = tpar.to_torch(case["kv_scales"]).clone()
    scales_new = kv_quant_scales(t["k_new"], t["v_new"])
    k2, v2 = t["k_new"][:, 2:].contiguous(), t["v_new"][:, 2:].contiguous()
    cache2 = full_cache[..., 2 * 16 * 2:].clone()
    scales2 = full_scales.clone()
    assert not torch.equal(kv_quant_scales(k2, v2), scales_new)
    if fused:
        want = fused_decode_attention_plain(t["q"], full_cache, t["k_new"], t["v_new"], meta,
                                            scale=0.25, kv_scales=full_scales)
        got = fused_decode_attention_plain(t["q"][:, 4:].contiguous(), cache2, k2, v2, meta,
                                           scale=0.25, kv_scales=scales2, scales_new=scales_new)
        n = tpar.valid_rows(case)
        torch.testing.assert_close(got[:n], want[:n, 4:], atol=1e-6, rtol=1e-6)
    else:
        write_kv_cache_quant_plain(full_cache, full_scales, t["k_new"], t["v_new"],
                                   meta.slot_mapping)
        write_kv_cache_quant_plain(cache2, scales2, k2, v2, meta.slot_mapping,
                                   scales_new=scales_new)
    assert torch.equal(cache2, full_cache[..., 2 * 16 * 2:])
    assert torch.equal(scales2.view(torch.int16), full_scales.view(torch.int16))


# -------------------------------------------------------------- lockstep
def test_lockstep_schedules_aborts_and_outputs_agree(tmp_path):
    """Two ranks of a tp = 2 service started by hand, chunked prefill over
    a tight budget: equal schedule traces, the abort of one request applied
    in the same step on both, the same outputs for the others."""
    from test_torch_tp import PROMPTS, WIDTHS, jax_params

    _, params = jax_params(WIDTHS)
    path = tpar.save_params(tmp_path / "llama.npz", params)
    prompts = PROMPTS + ["a fourth request, long enough to be aborted while it decodes"]
    ranks = tpar.spawn_ranks(tpar.lockstep_rank, 2, tmp_path, path, "llama", WIDTHS, prompts,
                             dict(enable_chunked_prefill=True, max_num_batched_tokens=64), None,
                             (6, "req-3"))
    r0, r1 = ranks
    assert r0["digest"] == r1["digest"]
    assert r0["steps"] == r1["steps"] > 6
    assert r0["aborted"] == r1["aborted"] == [("req-3", 6)]
    assert len(r0["outputs"]["req-3"]) < 12
    done = {rid: toks for rid, toks in r0["outputs"].items() if rid != "req-3"}
    assert done == r1["outputs"]


# ----------------------------------------------------- Mixtral logits at tp 2
@pytest.mark.parametrize("experts", [4, 3], ids=["expert-parallel", "intermediate-split"])
def test_mixtral_tp2_logits_match_jax(experts, tmp_path):
    """Both ranks' gathered logits over prefill, decode and mixed steps
    against the JAX model's (whose mesh forward equals its single-device
    one: ``tests/test_model_families.py``
    ``test_expert_parallel_matches_single_device``), and equal to each
    other."""
    from torch_parity import jax_meta

    widths = dict(MIXTRAL, num_local_experts=experts)
    jmodel = _jax_model(widths, "mixtral")
    jparams = jmodel.init_params(jax.random.PRNGKey(2))
    path = tpar.save_params(tmp_path / "mixtral.npz", jparams)
    rng = np.random.default_rng(4)
    stream = [rng.integers(2, 256, size=48).astype(np.int32) for _ in range(2)]
    steps = [((30, 21), (30, 21)), ((31, 22), (1, 1)), ((40, 32), (9, 10))]
    tables = [[3, 9, 1], [12, 0, 7]]
    ranks = tpar.spawn_ranks(tpar.logits_rank, 2, tmp_path, path, "mixtral", widths, steps,
                             stream, tables)
    jcache = jnp.zeros(jmodel.kv_cache_shape(16, 16), jnp.float32)
    for i, (seq_lens, q_lens) in enumerate(steps):
        case, positions, toks = model_step(seq_lens, q_lens, tables[: len(seq_lens)], stream)
        hidden, jcache = jmodel.forward(jparams, jnp.asarray(toks), jnp.asarray(positions),
                                        jcache, jax_meta(case))
        n = int(case["query_start_loc"][-1])
        want = np.asarray(jmodel.compute_logits(jparams, hidden))[:n]
        for rank in ranks:
            np.testing.assert_allclose(rank[i], want, atol=1e-4, rtol=1e-4)
        assert np.array_equal(ranks[0][i], ranks[1][i])
