"""The port's native (C++) block-manager core, against its Python manager,
against the JAX package's native manager, and through the service.

Mirrors ``tests/test_native_core.py`` on the port's own bindings
(``atoma_infer_tpu_torch/native``, which build ``csrc/atoma_core.cpp`` into
the port's build directory): allocation and free, copy-on-write, swap round
trips, the watermark, a randomized lifecycle, the sliding window, the slot
mapping and prefix caching, each equal to the port's Python
``BlockSpaceManager``. Then the port's native manager against JAX's
``NativeBlockSpaceManager`` on the same seeded operations (tables, copy-on-
write pairs, swap maps and free counts equal); the build (the port's own
directory, concurrent builds, a rebuild when the source is newer); which
manager ``LlmService.start`` picks; and the port's service on its default
native core against JAX's default ``LlmService`` on ``tiny_trained`` at
tp 1, tp 2 and pp 2, greedy tokens identical (at pp 2 every cohort shares
the one native pool).
"""

import asyncio
import os

import numpy as np
import pytest
import torch

import torch_parity as tpar
from torch_parity import FIXTURE_TINY_TRAINED as FIXTURE

from atoma_infer_tpu_torch import native
from atoma_infer_tpu_torch.core.block_manager import AllocationStatus, BlockSpaceManager
from atoma_infer_tpu_torch.native.block_manager import (
    NativeBlockSpaceManager,
    fill_slot_mapping_native,
)
from atoma_infer_tpu_torch.sequence import SequenceStatus

torch.set_num_threads(2)

BLOCK = 8
PORT = "atoma_infer_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _built():
    """The port's core builds here (g++): the tests below need it."""
    assert native.available(), "the port's native core did not build"


def make_group(request_id, seq_id, prompt_len, n=1, tokens=None, seq_mod=None):
    import atoma_infer_tpu_torch.sequence as default

    sm = seq_mod or default
    seqs = [sm.Sequence(seq_id + i, "x", list(tokens or range(prompt_len)), BLOCK)
            for i in range(n)]
    return sm.SequenceGroup(request_id=request_id, sequences=seqs)


def managers(device=16, host=8, sliding_window=None, prefix=False):
    py = BlockSpaceManager(BLOCK, device, host, sliding_window=sliding_window,
                           enable_prefix_caching=prefix)
    nat = NativeBlockSpaceManager(BLOCK, device, host, sliding_window=sliding_window,
                                  enable_prefix_caching=prefix)
    return py, nat


# --------------------------------------------- native against the Python manager
class TestNativeEquivalence:
    def test_allocate_and_free(self):
        py, nat = managers()
        g = make_group("r0", 0, prompt_len=20)
        assert py.can_allocate(g) == nat.can_allocate(g)
        py.allocate(g)
        nat.allocate(g)
        seq = g.get_first_seq()
        assert py.get_block_table_ids(0) == nat.get_block_table_ids(0)
        assert py.get_num_free_device_blocks() == nat.get_num_free_device_blocks()
        py.free(seq)
        nat.free(seq)
        assert py.get_num_free_device_blocks() == nat.get_num_free_device_blocks() == 16

    def test_append_with_cow(self):
        py, nat = managers()
        g = make_group("r0", 0, prompt_len=6)  # partial last block
        py.allocate(g)
        nat.allocate(g)
        seq = g.get_first_seq()
        seq.status = SequenceStatus.RUNNING
        child = seq.fork(1)  # the last block shared: the append copies it
        py.fork(seq, child)
        nat.fork(seq, child)
        assert py.last_block_shared(0) == nat.last_block_shared(0) is True
        seq.sequence_data.append_token_id(1, 0.0)
        pairs = py.append_slots(seq)
        assert pairs == nat.append_slots(seq) and len(pairs) == 1
        assert py.get_block_table_ids(0) == nat.get_block_table_ids(0)
        assert py.get_block_table_ids(1) == nat.get_block_table_ids(1)

    def test_swap_roundtrip(self):
        py, nat = managers(device=8, host=8)
        g = make_group("r0", 0, prompt_len=24)
        py.allocate(g)
        nat.allocate(g)
        seq = g.get_first_seq()
        seq.status = SequenceStatus.RUNNING
        assert py.can_swap_out(g) == nat.can_swap_out(g)
        assert py.swap_out(g) == nat.swap_out(g)
        seq.status = SequenceStatus.SWAPPED
        assert py.can_swap_in(g) == nat.can_swap_in(g)
        assert py.swap_in(g) == nat.swap_in(g)
        assert py.get_block_table_ids(0) == nat.get_block_table_ids(0)
        assert py.get_num_free_host_blocks() == nat.get_num_free_host_blocks() == 8

    def test_watermark_and_never(self):
        py, nat = managers(device=4, host=0)
        g_big = make_group("big", 0, prompt_len=BLOCK * 10)
        assert py.can_allocate(g_big) == nat.can_allocate(g_big) == AllocationStatus.NEVER
        g_ok = make_group("ok", 1, prompt_len=BLOCK * 3)
        assert py.can_allocate(g_ok) == nat.can_allocate(g_ok)

    def test_randomized_lifecycle(self):
        _lifecycle(BlockSpaceManager(BLOCK, 32, 16), NativeBlockSpaceManager(BLOCK, 32, 16),
                   make_group, seed=0)

    def test_sliding_window_reuse(self):
        py, nat = managers(sliding_window=BLOCK * 2)
        g = make_group("r0", 0, prompt_len=BLOCK * 4)
        py.allocate(g)
        nat.allocate(g)
        assert py.get_block_table_ids(0) == nat.get_block_table_ids(0)
        assert len(nat.get_block_table_ids(0)) == 2  # capped at the window's blocks

    def test_slot_mapping_matches_python(self):
        table = np.asarray([7, 2, 9, 4], dtype=np.int32)
        got = fill_slot_mapping_native(table, BLOCK, 5, 30)
        want = [int(table[(p // BLOCK) % len(table)]) * BLOCK + p % BLOCK
                for p in range(5, 30)]
        assert list(got) == want


def _lifecycle(a, b, group_of, *, seed, steps=300, seq_mods=(None, None)):
    """Drive managers ``a`` and ``b`` through the same seeded admissions,
    decode appends (copy-on-write pairs compared), frees and swap round
    trips, each group built for each with ``group_of``; every status,
    table and free count must agree at every step."""
    rng = np.random.RandomState(seed)
    live = {}
    next_id = 0
    for step in range(steps):
        op = rng.randint(0, 4)
        if op == 0 or not live:
            plen = int(rng.randint(1, 40))
            ga = group_of(f"r{next_id}", next_id, plen, seq_mod=seq_mods[0])
            gb = group_of(f"r{next_id}", next_id, plen, seq_mod=seq_mods[1])
            st_a, st_b = a.can_allocate(ga), b.can_allocate(gb)
            assert st_a.name == st_b.name, step
            if st_a.name == "OK":
                a.allocate(ga)
                b.allocate(gb)
                for g in (ga, gb):
                    seq = g.get_first_seq()
                    seq.status = type(seq.status).RUNNING
                live[next_id] = (ga, gb)
            next_id += 1
        elif op == 1:
            ga, gb = live[int(rng.choice(list(live)))]
            sa, sb = ga.get_first_seq(), gb.get_first_seq()
            if sa.status.name != "RUNNING":
                continue
            assert a.can_append_slots(ga) == b.can_append_slots(gb)
            if a.can_append_slots(ga):
                sa.sequence_data.append_token_id(0, 0.0)
                sb.sequence_data.append_token_id(0, 0.0)
                assert a.append_slots(sa) == b.append_slots(sb), step
        elif op == 2:
            ga, gb = live.pop(int(rng.choice(list(live))))
            a.free(ga.get_first_seq())
            b.free(gb.get_first_seq())
        else:
            ga, gb = live[int(rng.choice(list(live)))]
            sa, sb = ga.get_first_seq(), gb.get_first_seq()
            if sa.status.name != "RUNNING":
                continue
            assert a.can_swap_out(ga) == b.can_swap_out(gb), step
            if a.can_swap_out(ga):
                assert a.swap_out(ga) == b.swap_out(gb), step
                sa.status = type(sa.status).SWAPPED
                sb.status = type(sb.status).SWAPPED
                st = a.can_swap_in(ga)
                assert st.name == b.can_swap_in(gb).name, step
                if st.name == "OK":
                    assert a.swap_in(ga) == b.swap_in(gb), step
                    sa.status = type(sa.status).RUNNING
                    sb.status = type(sb.status).RUNNING
        assert a.get_num_free_device_blocks() == b.get_num_free_device_blocks(), step
        assert a.get_num_free_host_blocks() == b.get_num_free_host_blocks(), step
        for ga, gb in live.values():
            if a.has_block_table(ga.get_first_seq()):
                sid = ga.get_first_seq().seq_id
                assert a.get_block_table_ids(sid) == b.get_block_table_ids(sid), step


class TestNativePrefixCaching:
    """Content-hash prefix caching: the C++ core's cached allocator and LRU
    evictor against the Python ``CachedBlockAllocator``, block for block
    (tables, free counts with the evictable blocks, computed prefixes, the
    cached tokens a prompt skips)."""

    def _twin(self, request_id, seq_id, tokens, n=1):
        """The same group twice, distinct ``Sequence`` objects per manager
        (``allocate`` advances their computed tokens)."""
        return (make_group(request_id, seq_id, 0, n, tokens),
                make_group(request_id, seq_id, 0, n, tokens))

    def _finish_prefill(self, py, nat, g_py, g_nat):
        for mgr, g in ((py, g_py), (nat, g_nat)):
            for s in g.get_seqs():
                data = s.sequence_data
                delta = s.get_prompt_len() - data.get_num_computed_tokens()
                if delta > 0:
                    data.update_num_computed_tokens(delta)
                mgr.compute_full_blocks_in_sequence(s)

    def _computed(self, g):
        return g.get_first_seq().sequence_data.get_num_computed_tokens()

    def test_second_request_hits_cached_prefix(self):
        py, nat = managers(prefix=True)
        assert nat.enable_prefix_caching
        tokens = list(range(BLOCK * 3))
        a_py, a_nat = self._twin("a", 0, tokens)
        py.allocate(a_py)
        nat.allocate(a_nat)
        assert py.get_block_table_ids(0) == nat.get_block_table_ids(0)
        self._finish_prefill(py, nat, a_py, a_nat)
        assert py.get_all_computed_blocks(a_py.get_first_seq()) == nat.get_all_computed_blocks(
            a_nat.get_first_seq())
        b_py, b_nat = self._twin("b", 10, tokens)
        py.allocate(b_py)
        nat.allocate(b_nat)
        assert py.get_block_table_ids(10) == nat.get_block_table_ids(10) == \
            py.get_block_table_ids(0)
        # A whole prompt cached: one token is recomputed (prompt_len - 1).
        assert self._computed(b_py) == self._computed(b_nat) == len(tokens) - 1
        assert py.get_num_free_device_blocks() == nat.get_num_free_device_blocks()

    def test_revive_after_free(self):
        py, nat = managers(device=8, host=0, prefix=True)
        tokens = list(range(BLOCK * 2))
        a_py, a_nat = self._twin("a", 0, tokens)
        py.allocate(a_py)
        nat.allocate(a_nat)
        self._finish_prefill(py, nat, a_py, a_nat)
        py.access_all_blocks_in_sequence(a_py.get_first_seq(), 1.0)
        nat.access_all_blocks_in_sequence(a_nat.get_first_seq(), 1.0)
        py.free(a_py.get_first_seq())
        nat.free(a_nat.get_first_seq())
        assert py.get_num_free_device_blocks() == nat.get_num_free_device_blocks() == 8
        b_py, b_nat = self._twin("b", 10, tokens)
        py.allocate(b_py)
        nat.allocate(b_nat)
        assert py.get_block_table_ids(10) == nat.get_block_table_ids(10)
        assert self._computed(b_py) == self._computed(b_nat) == len(tokens) - 1

    def test_eviction_under_pressure_matches(self):
        py, nat = managers(device=6, host=0, prefix=True)
        t1, t2 = list(range(BLOCK * 2)), list(range(100, 100 + BLOCK * 2))
        for rid, sid, toks, ts in (("a", 0, t1, 1.0), ("b", 10, t2, 2.0)):
            g_py, g_nat = self._twin(rid, sid, toks)
            py.allocate(g_py)
            nat.allocate(g_nat)
            self._finish_prefill(py, nat, g_py, g_nat)
            py.access_all_blocks_in_sequence(g_py.get_first_seq(), ts)
            nat.access_all_blocks_in_sequence(g_nat.get_first_seq(), ts)
            py.free(g_py.get_first_seq())
            nat.free(g_nat.get_first_seq())
        c_py, c_nat = self._twin("c", 20, list(range(200, 200 + BLOCK * 5)))
        py.allocate(c_py)
        nat.allocate(c_nat)
        assert py.get_block_table_ids(20) == nat.get_block_table_ids(20)
        assert py.get_num_free_device_blocks() == nat.get_num_free_device_blocks()
        py.free(c_py.get_first_seq())
        nat.free(c_nat.get_first_seq())
        d_py, d_nat = self._twin("d", 30, t2)
        py.allocate(d_py)
        nat.allocate(d_nat)
        assert py.get_block_table_ids(30) == nat.get_block_table_ids(30)
        assert self._computed(d_py) == self._computed(d_nat)

    def test_partial_block_not_hashed(self):
        py, nat = managers(prefix=True)
        tokens = list(range(BLOCK + 3))
        a_py, a_nat = self._twin("a", 0, tokens)
        py.allocate(a_py)
        nat.allocate(a_nat)
        self._finish_prefill(py, nat, a_py, a_nat)
        b_py, b_nat = self._twin("b", 10, tokens)
        py.allocate(b_py)
        nat.allocate(b_nat)
        table = py.get_block_table_ids(10)
        assert table == nat.get_block_table_ids(10)
        assert table[0] == py.get_block_table_ids(0)[0] and table[1] != py.get_block_table_ids(0)[1]
        assert self._computed(b_py) == self._computed(b_nat) == BLOCK

    def test_prefix_caching_off_under_a_sliding_window(self):
        py, nat = managers(sliding_window=BLOCK * 2, prefix=True)
        assert py.enable_prefix_caching is nat.enable_prefix_caching is False

    def test_randomized_prefix_lifecycle(self):
        rng = np.random.RandomState(7)
        py, nat = managers(device=24, host=0, prefix=True)
        prompts = [list(range(p, p + BLOCK * rng.randint(1, 4)))
                   for p in (0, 50, 100, 0, 50, 150, 0)]
        live, sid = [], 0
        for step in range(60):
            if rng.rand() < 0.5 and len(live) < 5:
                g_py, g_nat = self._twin(f"r{step}", sid, prompts[rng.randint(len(prompts))])
                sid += 10
                st = py.can_allocate(g_py)
                assert st == nat.can_allocate(g_nat)
                if st != AllocationStatus.OK:
                    continue
                py.allocate(g_py)
                nat.allocate(g_nat)
                assert self._computed(g_py) == self._computed(g_nat)
                self._finish_prefill(py, nat, g_py, g_nat)
                py.access_all_blocks_in_sequence(g_py.get_first_seq(), float(step))
                nat.access_all_blocks_in_sequence(g_nat.get_first_seq(), float(step))
                live.append((g_py, g_nat))
            elif live:
                g_py, g_nat = live.pop(rng.randint(len(live)))
                py.free(g_py.get_first_seq())
                nat.free(g_nat.get_first_seq())
            for g_py, g_nat in live:
                assert py.get_block_table_ids(g_py.get_first_seq().seq_id) == \
                    nat.get_block_table_ids(g_nat.get_first_seq().seq_id)
            assert py.get_num_free_device_blocks() == nat.get_num_free_device_blocks()


# ------------------------------------------------ the port's native against JAX's
def _jax_native():
    mod = pytest.importorskip("atoma_infer_tpu.native")
    assert mod.available(), "the JAX package's native core did not build"
    from atoma_infer_tpu.native.block_manager import NativeBlockSpaceManager as JaxNative

    return JaxNative


def test_native_manager_matches_jax_native_manager():
    """The same seeded operations on the port's and JAX's native managers
    (each over its own build of ``csrc/atoma_core.cpp``, with its own
    sequences): statuses, tables, copy-on-write pairs, swap maps and free
    counts equal at every step."""
    import atoma_infer_tpu.sequence as jax_seq

    JaxNative = _jax_native()
    _lifecycle(NativeBlockSpaceManager(BLOCK, 32, 16), JaxNative(BLOCK, 32, 16), make_group,
               seed=3, seq_mods=(None, jax_seq))


def test_native_prefix_caching_matches_jax_native_manager():
    """Prefix caching on both native managers: the same prompts (shared
    prefixes, revivals, evictions under a small pool) give the same tables,
    cached tokens and free counts."""
    import atoma_infer_tpu.sequence as jax_seq

    JaxNative = _jax_native()
    port, ref = (NativeBlockSpaceManager(BLOCK, 12, 0, enable_prefix_caching=True),
                 JaxNative(BLOCK, 12, 0, enable_prefix_caching=True))
    rng = np.random.RandomState(11)
    prompts = [list(range(p, p + BLOCK * k)) for p, k in ((0, 3), (0, 2), (40, 3), (80, 4))]
    live = []
    for step in range(80):
        if rng.rand() < 0.55 and len(live) < 3:
            toks = prompts[rng.randint(len(prompts))] + [int(rng.randint(500, 600))]
            pair = [make_group(f"r{step}", 10 * step, 0, tokens=toks, seq_mod=m)
                    for m in (None, jax_seq)]
            if port.can_allocate(pair[0]).name != "OK":
                assert ref.can_allocate(pair[1]).name != "OK"
                continue
            for mgr, g in zip((port, ref), pair):
                mgr.allocate(g)
            cached = [g.get_first_seq().sequence_data.get_num_computed_tokens() for g in pair]
            assert cached[0] == cached[1], step
            for mgr, g in zip((port, ref), pair):
                s = g.get_first_seq()
                s.sequence_data.update_num_computed_tokens(
                    s.get_prompt_len() - s.sequence_data.get_num_computed_tokens())
                mgr.compute_full_blocks_in_sequence(s)
                mgr.access_all_blocks_in_sequence(s, float(step))
            live.append(pair)
        elif live:
            pair = live.pop(rng.randint(len(live)))
            for mgr, g in zip((port, ref), pair):
                mgr.free(g.get_first_seq())
        for a, b in live:
            assert port.get_block_table_ids(a.get_first_seq().seq_id) == \
                ref.get_block_table_ids(b.get_first_seq().seq_id), step
        assert port.get_num_free_device_blocks() == ref.get_num_free_device_blocks(), step


# ------------------------------------------------------------------- the build
def test_build_goes_to_the_port_directory_and_rebuilds_when_stale(tmp_path, monkeypatch):
    """The library is the port's own (``atoma_infer_tpu_torch/csrc/build``,
    never the repository's ``csrc/build``); a source newer than it makes it
    stale, and a rebuild replaces it in place."""
    assert native.LIB_PATH.parent.parts[-3:] == ("atoma_infer_tpu_torch", "csrc", "build")
    assert native.SOURCE.parent.name == "csrc" and native.SOURCE.exists()
    src = tmp_path / "atoma_core.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libatoma_core.so")
    assert native._stale()
    native.build()
    assert not native._stale()
    t = src.stat().st_mtime
    os.utime(native.LIB_PATH, (t - 10, t - 10))  # the source is now the newer
    assert native._stale()
    native.build()
    assert not native._stale()
    assert not list((tmp_path / "build").glob("*.tmp"))


def _build_and_load(src, lib, out):
    import ctypes

    from atoma_infer_tpu_torch import native as mod

    mod.SOURCE, mod.LIB_PATH = type(mod.SOURCE)(src), type(mod.SOURCE)(lib)
    mod.build()
    h = mod._declare(ctypes.CDLL(lib)).abm_create(8, 4, 0, 0.01, -1)
    with open(out, "w") as f:
        f.write("ok" if h else "null")


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Three processes building at once (test workers, spawned ranks): each
    writes a name of its own and moves it into place, so every one loads a
    whole library."""
    src = tmp_path / "atoma_core.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    lib = tmp_path / "build" / "libatoma_core.so"
    ctx = torch.multiprocessing.get_context("spawn")
    outs = [tmp_path / f"out{i}" for i in range(3)]
    procs = [ctx.Process(target=_build_and_load, args=(str(src), str(lib), str(o)))
             for o in outs]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    assert [o.read_text() for o in outs] == ["ok"] * 3


# ------------------------------------------------------------- the service
@pytest.mark.parametrize("sched, native_core", [
    ({}, True),
    ({"use_native_core": False}, False),
    ({"num_speculative_tokens": 3}, False),
], ids=["default", "python", "speculative"])
def test_service_picks_its_block_manager(sched, native_core):
    """``LlmService.start`` takes the native manager by default, the Python
    one when ``use_native_core`` is off, and the Python one under
    speculative decoding (its multi-block copy-on-write), as JAX's
    ``_build_block_manager`` does."""
    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    raw = {"inference": {"model_name": "tiny-random"},
           "scheduler": {"max_model_len": 256, **sched}}
    service = LlmService.start(EngineConfig.from_dict(raw), device="cpu")
    assert service.native_core is native_core
    kind = NativeBlockSpaceManager if native_core else BlockSpaceManager
    assert type(service.block_manager) is kind
    assert service.block_manager is service.engine.scheduler.block_manager
    got = tpar.generate(service, ["native core", "a second prompt"], max_new_tokens=6)
    assert all(len(t) == 6 for t in got.values())


PROMPTS = [f"prompt number {i} " * (1 + i % 4) for i in range(5)]


def tiny_trained_config(pkg, *, tp=1, pp=1, coordinator_address=None, **sched):
    """``tiny_trained`` from its directory, f32, with the default block
    manager (the native core) unless ``sched`` says otherwise."""
    import importlib

    cfg = importlib.import_module(f"{pkg}.config")
    kw = dict(max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
              enable_chunked_prefill=False)
    kw.update(sched)
    model = dict(model_name=FIXTURE, dtype="float32", tensor_parallel_size=tp,
                 pipeline_parallel_size=pp)
    if coordinator_address:
        model["coordinator_address"] = coordinator_address
    return cfg.EngineConfig(
        model=cfg.ModelConfig(**model),
        cache=cfg.CacheConfig(block_size=16, num_device_blocks_override=96,
                              num_host_blocks_override=16),
        scheduler=cfg.SchedulerConfig(**kw),
        validation=cfg.ValidationConfig(max_input_tokens=200, max_total_tokens=256),
    )


def jax_tokens(config, prompts, max_new=12):
    from atoma_infer_tpu.engine.llm_service import LlmService
    from atoma_infer_tpu.types import GenerateParameters, GenerateRequest

    service = LlmService.start(config, model_dir=FIXTURE)

    async def run():
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(GenerateRequest(
            request_id=f"req-{i}", inputs=p,
            parameters=GenerateParameters(max_new_tokens=max_new, do_sample=False)))
            for i, p in enumerate(prompts)]
        out = await asyncio.wait_for(asyncio.gather(*futs), timeout=180)
        service.stop()
        task.cancel()
        return {r.request_id: list(r.outputs[0].token_ids) for r in out}

    return asyncio.run(run()), service


@pytest.mark.parametrize("tp, pp", [(1, 1), (2, 1), (1, 2)], ids=["tp1", "tp2", "pp2"])
def test_native_service_matches_jax_default_service(tp, pp, tmp_path):
    """The port's service on its default block manager (the native core)
    against JAX's default ``LlmService`` on ``tiny_trained``: greedy tokens
    identical; every cohort of pp 2 on the one native pool, every block
    back in it after the traffic."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    want, jservice = jax_tokens(tiny_trained_config("atoma_infer_tpu", tp=tp, pp=pp), PROMPTS)
    assert type(jservice.engine.scheduler.block_manager).__name__ == "NativeBlockSpaceManager"
    config = tiny_trained_config(PORT, tp=tp, pp=pp,
                                 coordinator_address=tpar.rendezvous_file(tmp_path))
    service = LlmService.start(config, model_dir=FIXTURE, device="cpu")
    assert service.native_core
    managers = {id(s.block_manager) for s in service.engine.schedulers}
    assert len(service.engine.schedulers) == pp and len(managers) == 1
    got = tpar.generate(service, PROMPTS)
    assert got == want
    assert service.block_manager.get_num_free_device_blocks() == 96

