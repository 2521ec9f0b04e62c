"""Kernels F and G on the tensor cores (``qmm_mma_kernel`` in the port's
``csrc/quant_matmul.cu``), modelled on the CPU.

The CUDA kernel runs only on the card. What can be checked here:
- the widening bit tricks, in a numpy model of the instructions: every int8
  byte and every biased int4 nibble becomes its bf16 value exactly;
- the kernel's data flow, in a numpy model of its copies into shared memory
  (swizzles, the int4 halves' x columns, zero-fill), its fragment reads
  (ldmatrix rows, the B column map), the mma fragment layouts, the groups'
  scaling and the K splits: the assembled product equals the plain version
  within 1e-5 of the output's largest value (f32 sums in another order);
- the route and plan function: which kernel a call takes, its block rows,
  the K splits and the workspace;
- the plain version against the JAX package's XLA branch (f32, rtol 1e-5 of
  the largest value) and its Pallas kernel in interpret mode (bf16, one bf16
  ulp: rtol 2^-7) at the shapes the new route adds: M = 17 and 256, groups
  of 32 and 64, and one group.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu.ops import quant as jquant
from atoma_infer_tpu_torch.ops import quant, quant_kernels as qk

torch.set_num_threads(2)


# ----------------------------------------------------- the instructions, in numpy
def byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)`` on uint32 arrays (selector nibbles 0-7)."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 7] << (8 * k)
    return out.astype(np.uint32)


def pair_selector(j):
    return j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)


def bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(v):
    """Round to nearest even, as ``fma.rn.bf16x2`` rounds its result."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def fma_bf16x2(a, b, c):
    """``fma.rn.bf16x2``: per half, a·b + c rounded once to bf16."""
    halves = []
    for shift in (0, 16):
        def f(w):
            return bf16_bits_to_f32((np.asarray(w, np.uint32) >> shift) & 0xFFFF).astype(np.float64)
        halves.append(f32_to_bf16_bits((f(a) * f(b) + f(c)).astype(np.float32)))
    return (halves[0] | (halves[1] << 16)).astype(np.uint32)


def widen_pair(lo, hi, j):
    """``widen_pair`` of ``csrc/mma_sm90.cuh``: byte j of lo and hi as int8 in bf16."""
    p = byte_perm(lo, hi, pair_selector(j))
    pos = (p & 0x007F007F) | 0x43004300
    neg = (p & 0x00800080) | 0x43004300
    return fma_bf16x2(neg, 0xBF80BF80, pos)


def widen_nibbles(lo, hi, j, high):
    """``widen_nibbles`` of ``csrc/quant_matmul.cu``: the low or high nibble of
    byte j of lo and hi, stored as q + 8, as q in bf16."""
    p = byte_perm(lo, hi, pair_selector(j))
    if high:
        p = p >> 4
    return fma_bf16x2((p & 0x000F000F) | 0x43004300, 0x3F803F80, 0xC308C308)


def halves_f32(words):
    w = np.asarray(words, np.uint32)
    return bf16_bits_to_f32(w & 0xFFFF), bf16_bits_to_f32(w >> 16)


def _words(rng, byte_j, j):
    """Random words whose byte j is ``byte_j``."""
    w = rng.integers(0, 2**32, size=byte_j.shape, dtype=np.uint64).astype(np.uint32)
    mask = np.uint32(0xFF << (8 * j))
    return (w & ~mask) | (byte_j.astype(np.uint32) << (8 * j))


@pytest.mark.parametrize("j", range(4))
def test_widen_pair_is_exact_for_every_int8(j):
    rng = np.random.default_rng(j)
    v = np.arange(256, dtype=np.uint32)
    u = rng.permutation(256).astype(np.uint32)
    lo, hi = halves_f32(widen_pair(_words(rng, v, j), _words(rng, u, j), j))
    np.testing.assert_array_equal(lo, v.astype(np.uint8).view(np.int8).astype(np.float32))
    np.testing.assert_array_equal(hi, u.astype(np.uint8).view(np.int8).astype(np.float32))


@pytest.mark.parametrize("high", [0, 1])
@pytest.mark.parametrize("j", range(4))
def test_widen_nibbles_is_exact_for_every_int4(j, high):
    rng = np.random.default_rng(10 + j)
    n = np.repeat(np.arange(16, dtype=np.uint32), 16)   # the nibble widened
    other = np.tile(np.arange(16, dtype=np.uint32), 16)  # the byte's other nibble
    m = rng.permutation(n)
    byte_lo = (n << 4 | other) if high else (other << 4 | n)
    byte_hi = (m << 4 | other) if high else (other << 4 | m)
    lo, hi = halves_f32(widen_nibbles(_words(rng, byte_lo, j), _words(rng, byte_hi, j), j, high))
    np.testing.assert_array_equal(lo, n.astype(np.float32) - 8)
    np.testing.assert_array_equal(hi, m.astype(np.float32) - 8)


# ------------------------------------------------- the kernel's data flow, in numpy
BN, PASSES = 128, 8  # kMmaBN, kMmaPasses
M_TILES_WARPS = {16: (1, 1), 32: (2, 1), 64: (4, 1), 128: (4, 2)}  # block rows -> (MT, WM)
# The blocks an H100 SM holds at once by bits and block rows: the occupancy
# calculator's answer (``atoma_qmm_mma_blocks_per_sm``) for the build that
# PERF.md measured, given here as the card would give it.
H100_BLOCKS_PER_SM = {8: {16: 3, 32: 2, 64: 2, 128: 1}, 4: {16: 4, 32: 3, 64: 2, 128: 1}}
H100_SMS = 132


def h100_slots(bits, block_rows):
    return H100_BLOCKS_PER_SM[bits][block_rows] * H100_SMS


def _tile_rows(bits):
    """Weight rows a k tile of 128 k (``MmaTile::kWRows``)."""
    return 128 if bits == 8 else 64


def _pass(bits, u):
    """Pass u's (weight step, x sub-tile, chunk pair, last pass of its step)."""
    if bits == 8:
        return u, u >> 2, u & 3, True
    return u >> 1, u & 1, u >> 1, bool(u & 1)


def _load_tile(xb, qb, sb, *, bits, rg, M, N, m0, n0, r0, r_end, bm):
    """A stage's bytes as ``load_tile`` writes them (x sub-tiles, weight
    tile, scale slots; chunks swizzled, what is out of range zero)."""
    rows = _tile_rows(bits)
    xt = np.zeros(2 * bm * 128, np.uint8)
    wt = np.zeros(rows * 128, np.uint8)
    st = np.zeros(rows // 16 * 2 * BN, np.uint8)
    for r in range(rows):
        for cc in range(8):
            if r0 + r < r_end and n0 + 16 * cc < N:
                dst = r * 128 + ((cc ^ (((r >> 1) & 3) << 1)) << 4)
                wt[dst:dst + 16] = qb[r0 + r, n0 + 16 * cc:n0 + 16 * cc + 16]
    for cc in range(8):
        xp = cc >> 1
        for h in range(2):
            if bits == 8:
                step, xcol = 4 * h + xp, r0 + 64 * h + 16 * xp + 8 * (cc & 1)
            else:
                rs = r0 + 16 * xp
                step, xcol = xp, rs + (rs // rg + h) * rg + 8 * (cc & 1)
            for r in range(bm):
                if r0 + 16 * step < r_end and m0 + r < M:
                    dst = (h * bm + r) * 128 + ((cc ^ (r & 7)) << 4)
                    xt[dst:dst + 16] = xb[m0 + r, 2 * xcol:2 * xcol + 16]
    for s in range(rows // 16):
        rr = r0 + 16 * s
        if rr < r_end and (rr + 16) % rg == 0:
            for c in range(16):
                if n0 + 8 * c < N:
                    sb_row = sb[rr // rg, 2 * (n0 + 8 * c):2 * (n0 + 8 * c) + 16]
                    st[s * 2 * BN + 16 * c:s * 2 * BN + 16 * c + 16] = sb_row
    return xt, wt, st


def _u32(buf, addr):
    """32-bit little-endian words of ``buf`` at byte addresses ``addr``."""
    addr = np.asarray(addr)
    return sum(buf[addr + i].astype(np.uint32) << (8 * i) for i in range(4)).astype(np.uint32)


LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def _a_fragment(xt, base):
    """ldmatrix.x4 at per-lane row addresses ``base`` (16 bytes each): lanes
    8i..8i+7 give matrix i's rows; the result is A [16, 16] as the
    m16n8k16 A fragment reads those registers (a0 rows 0-7 k 0-7, a1 rows
    8-15 k 0-7, a2 rows 0-7 k 8-15, a3 rows 8-15 k 8-15)."""
    mats = np.stack([xt[b:b + 16].view(np.uint16) for b in base]).reshape(4, 8, 8)
    a = np.zeros((16, 16), np.float32)
    for i in range(4):
        r, k = 8 * (i & 1), 8 * (i >> 1)
        a[r:r + 8, k:k + 8] = bf16_bits_to_f32(mats[i])
    return a


def mma_model(x, qweight, scales, *, bits, group_size):
    """The tensor-core kernel's result for bf16-valued f32 ``x`` [M, K],
    modelled pass by pass; returns f32 [M, N]."""
    M, K = x.shape
    N = qweight.shape[1]
    G = group_size
    rg = G if bits == 8 else G // 2
    tile_rows = _tile_rows(bits)
    block_rows, gps, splits = qk.mma_plan(M, N, K // G, h100_slots(bits, qk.mma_block_rows(M)))
    mt, wm_n = M_TILES_WARPS[block_rows]
    xb = f32_to_bf16_bits(x).astype(np.uint16).view(np.uint8).reshape(M, 2 * K)
    qb = qweight.numpy().view(np.uint8)
    sb = scales.view(torch.int16).numpy().view(np.uint8)
    ws = np.zeros((splits, M, N), np.float32)
    for z in range(splits):
        r_begin, r_end = z * gps * rg, min(K // G, (z + 1) * gps) * rg
        for m0 in range(0, M, block_rows):
            for n0 in range(0, N, BN):
                for warp in range(4 * wm_n):
                    wn, wm = (warp & 3) * 32, (warp >> 2) * 16 * mt
                    acc = np.zeros((mt, 4, 16, 8), np.float32)
                    tot = np.zeros((mt, 4, 16, 8), np.float32)
                    for r0 in range(r_begin, r_end, tile_rows):
                        xt, wt, st = _load_tile(xb, qb, sb, bits=bits, rg=rg, M=M, N=N, m0=m0,
                                                n0=n0, r0=r0, r_end=r_end, bm=block_rows)
                        valid = min(tile_rows // 16, (r_end - r0) // 16)
                        b_off = (2 * TIG * 128 + (((wn // 16 + (GID >> 2)) ^ (TIG << 1)) << 4)
                                 + 4 * (GID & 3))
                        for u in range(PASSES):
                            s, h, pair, last = _pass(bits, u)
                            if s >= valid:
                                continue
                            base = b_off + 16 * s * 128
                            bw = [_u32(wt, base + d * 128) for d in (0, 1, 8, 9)]
                            chunk = ((2 * pair + (LANE >> 4)) ^ (LANE & 7)) << 4
                            for mi in range(mt):
                                rows = h * block_rows + wm + 16 * mi + (LANE & 15)
                                a = _a_fragment(xt, rows * 128 + chunk)
                                for j in range(4):
                                    if bits == 8:
                                        b0, b1 = widen_pair(bw[0], bw[1], j), widen_pair(bw[2], bw[3], j)
                                    else:
                                        b0 = widen_nibbles(bw[0], bw[1], j, u & 1)
                                        b1 = widen_nibbles(bw[2], bw[3], j, u & 1)
                                    # B [16, 8]: lane (gid, tig) holds B[2 tig, 2 tig + 1][gid]
                                    # in b0 and B[2 tig + 8, 2 tig + 9][gid] in b1.
                                    b = np.zeros((16, 8), np.float32)
                                    for reg, k0 in ((b0, 0), (b1, 8)):
                                        lo, hi = halves_f32(reg)
                                        b[k0 + 2 * TIG, GID] = lo
                                        b[k0 + 2 * TIG + 1, GID] = hi
                                    prod = a.astype(np.float64) @ b.astype(np.float64)
                                    acc[mi, j] = (acc[mi, j] + prod).astype(np.float32)
                            rr = r0 + 16 * s
                            if last and (rr + 16) % rg == 0:
                                # lane (gid, tig)'s 8 scales: columns wn + 8 tig ..
                                sc = bf16_bits_to_f32(np.stack([
                                    st[s * 2 * BN + 2 * (wn + 8 * t):][:16].view(np.uint16)
                                    for t in range(4)]))  # [tig, 8]
                                for j in range(4):
                                    # logical column n = 2 tig + c is column 4 c + j of lane tig's 8
                                    scale = np.array([sc[n // 2, 4 * (n % 2) + j] for n in range(8)],
                                                     np.float32)
                                    tot[:, j] = (tot[:, j] + acc[:, j] * scale).astype(np.float32)
                                acc[:] = 0
                    # Epilogue: logical column n of n8 tile j is physical column wn + 4 n + j.
                    for mi in range(mt):
                        for j in range(4):
                            for n in range(8):
                                col = n0 + wn + 4 * n + j
                                rows = m0 + wm + 16 * mi + np.arange(16)
                                keep = rows < M
                                if col < N:
                                    ws[z, rows[keep], col] = tot[mi, j, keep, n]
    out = np.zeros((M, N), np.float32)
    for z in range(splits):  # split_reduce_kernel's fixed order
        out = (out + ws[z]).astype(np.float32)
    return out


def _quantized(bits, K, N, group, M, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    return x.to(torch.bfloat16).float(), quant.quantize_weight(w, bits, group)


# (K, N, group, M): a decode block of 16 rows, partial column tiles (N =
# 144), groups of 16 and 32 (several a tile; splits end mid-tile), one
# group, and the larger blocks (32, 64, 128 rows) with rows past M.
@pytest.mark.parametrize("bits, K, N, group, M", [
    (8, 256, 128, 128, 1),
    (8, 128, 144, 16, 8),
    (8, 192, 256, 64, 20),
    (8, 128, 128, 128, 64),
    (8, 128, 128, 32, 130),
    (4, 256, 128, 128, 3),
    (4, 128, 144, 32, 16),
    (4, 256, 128, 256, 17),
    (4, 192, 128, 64, 40),
    (4, 256, 128, 64, 129),
])
def test_mma_model_matches_plain(bits, K, N, group, M):
    x, qt = _quantized(bits, K, N, group, M, seed=K + N + M + bits)
    want = qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits, group_size=group)
    got = mma_model(x.numpy(), qt.qweight, qt.scales, bits=bits, group_size=group)
    scale = np.abs(want.numpy()).max()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5 * scale)


# ------------------------------------------------------- the route and the plan
def _operands(M, K, N, bits, group, *, dtype=torch.bfloat16, offset=None):
    """Uninitialised operands of one call; ``offset`` names the one tensor
    placed off 16-byte alignment (a view 1 element into a larger tensor)."""
    def alloc(shape, dt, name):
        n = int(np.prod(shape))
        if offset != name:
            return torch.empty(shape, dtype=dt)
        return torch.empty(n + 16, dtype=dt)[1:1 + n].view(shape)

    x = alloc((M, K), dtype, "x")
    q = alloc((K // (2 if bits == 4 else 1), N), torch.int8, "q")
    s = alloc((K // group, N), torch.bfloat16, "scales")
    return x, q, s


MMA8, MMA4 = "quantized_matmul_int8_mma", "quantized_matmul_int4_mma"


@pytest.mark.parametrize("case, M, K, N, group, bits, kw, want", [
    # Decode at Llama-3.1-8B widths: one m16 tile a warp, K split in whole
    # groups into as many splits as one wave of resident blocks holds (at 16
    # rows, 3 INT8 or 4 INT4 blocks an SM: 396 or 528).
    ("gate decode", 8, 4096, 14336, 128, 8, {}, (MMA8, (16, 11), (3, 8, 14336))),
    ("q/o decode int4", 8, 4096, 4096, 128, 4, {}, (MMA4, (16, 2), (16, 8, 4096))),
    ("k/v decode", 8, 4096, 1024, 128, 8, {}, (MMA8, (16, 1), (32, 8, 1024))),
    ("down decode", 8, 14336, 4096, 128, 4, {}, (MMA4, (16, 7), (16, 8, 4096))),
    ("lm head", 8, 4096, 128256, 4096, 8, {}, (MMA8, (16, 1), None)),
    ("17 rows", 17, 4096, 4096, 128, 8, {}, (MMA8, (32, 4), (8, 17, 4096))),
    ("64 rows", 64, 4096, 14336, 128, 4, {}, (MMA4, (64, 16), (2, 64, 14336))),
    # Prefill chunks: 128 rows a block (one an SM), split only below a wave.
    ("gate prefill", 256, 4096, 14336, 128, 8, {}, (MMA8, (128, 32), None)),
    ("down prefill", 256, 14336, 4096, 128, 4, {}, (MMA4, (128, 56), (2, 256, 4096))),
    # What the tensor cores do not take goes to the CUDA cores.
    ("f32", 8, 4096, 14336, 128, 8, dict(dtype=torch.float32),
     ("quantized_matmul_int8", (0, 8, 8, 1, 16), (2, 8, 14336))),
    ("misaligned x", 8, 256, 256, 128, 8, dict(offset="x"), ("quantized_matmul_int8", None, None)),
    ("misaligned weight", 8, 256, 256, 128, 4, dict(offset="q"),
     ("quantized_matmul_int4", None, None)),
    ("misaligned scales", 8, 256, 256, 128, 8, dict(offset="scales"),
     ("quantized_matmul_int8", None, None)),
    ("N % 16 == 8", 8, 256, 72, 128, 8, {}, ("quantized_matmul_int8", None, None)),
    ("N = 200", 8, 256, 200, 128, 4, {}, ("quantized_matmul_int4", None, None)),
    ("int4 group 16", 8, 256, 256, 16, 4, {}, ("quantized_matmul_int4", None, None)),
    ("int8 group 24", 8, 240, 256, 24, 8, {}, ("quantized_matmul_int8", None, None)),
])
def test_route_and_plan(case, M, K, N, group, bits, kw, want, monkeypatch):
    # The card's occupancy answer, as an H100 gives it for this build.
    asked = []
    monkeypatch.setattr(qk, "_mma_slots",
                        lambda b, rows, device: asked.append((b, rows)) or h100_slots(b, rows))
    x, q, s = _operands(M, K, N, bits, group, **kw)
    launch = qk.qmm_launch(x, q, s, bits=bits, group_size=group)
    name, geometry, workspace = want
    assert launch.kernel.name == name, case
    if geometry is not None:
        assert launch.geometry == geometry
        assert launch.workspace == workspace
    if launch.kernel.name.endswith("_mma"):
        block_rows, gps = launch.geometry
        assert asked == [(bits, block_rows)]
        splits = -(-(K // group) // gps)
        assert (splits > 1) == (launch.workspace is not None)
        blocks = -(-N // 128) * -(-M // block_rows) * splits
        assert splits == 1 or blocks <= h100_slots(bits, block_rows)
    else:
        # The CUDA-core plan: bf16 flag first, then plan()'s geometry.
        assert asked == []
        vec, ks, rsplit, gps, splits = qk._cuda_core_geometry(M, N, K // group, q)
        assert launch.geometry == (int(x.dtype == torch.bfloat16), vec, ks, rsplit, gps)
        assert launch.workspace == ((splits, M, N) if splits > 1 else None)


@pytest.mark.parametrize("M, want_rows", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 64),
                                          (64, 64), (65, 128), (300, 128)])
def test_block_rows_follow_m(M, want_rows):
    assert qk.mma_block_rows(M) == want_rows
    for bits in (8, 4):
        block_rows, gps, splits = qk.mma_plan(M, 4096, 32, h100_slots(bits, want_rows))
        assert block_rows == want_rows
        assert splits == -(-32 // gps) and 1 <= gps <= 32
        # A card that holds more blocks at once gets more splits, never fewer.
        assert qk.mma_plan(M, 4096, 32, 4 * 132 * 4)[2] >= splits


# --------------------------------------------- the plain version against JAX
def _case(bits, K, N, group, M, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, jquant.quantize_weight(jnp.asarray(w), bits, group), quant.quantize_weight(
        torch.from_numpy(w), bits, group)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale * 0.5 + 1e-6 * scale)


@pytest.mark.parametrize("M", [17, 256])
@pytest.mark.parametrize("bits, group", [(8, 32), (8, 64), (8, 256), (4, 32), (4, 64), (4, 256)])
def test_plain_f32_matches_xla_branch_at_new_shapes(bits, group, M):
    x, jq, pq = _case(bits, 256, 144, group, M, seed=M + group + bits)
    want = np.asarray(jquant.quantized_matmul(jnp.asarray(x), jq))
    got = quant.quantized_matmul(torch.from_numpy(x), pq)
    assert got.dtype == torch.float32 and got.shape == (M, 144)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("M", [17, 256])
@pytest.mark.parametrize("bits, group", [(8, 32), (8, 64), (8, 256), (4, 32), (4, 64), (4, 256)])
def test_plain_bf16_matches_pallas_interpret_at_new_shapes(bits, group, M):
    from jax.experimental.pallas import tpu as pltpu

    from atoma_infer_tpu.ops.quant_kernels import quantized_matmul_pallas

    x, jq, pq = _case(bits, 256, 256, group, M, seed=3 * M + group + bits)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = quantized_matmul_pallas(xb, jq.qweight, jq.scales, bits=bits,
                                       group_size=jq.group_size)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = quant.quantized_matmul(xt, pq)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2.0**-7)


# ------------------------------------------------------- the ablation tool
def test_qmm_ablation_builds_hooks_the_source_has():
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import qmm_ablation

    source = qmm_ablation.SOURCE.read_text()
    assert qmm_ablation.VARIANTS["port"] == ()
    for flags in qmm_ablation.VARIANTS.values():
        for flag in flags:
            assert flag.startswith("-D") and flag[2:].split("=")[0] in source
    # The port's own build defines none of them.
    assert not any(flag.startswith("-DATOMA_QMM") for flag in cuda_lib.NVCC_FLAGS)


def test_qmm_ablation_needs_a_card():
    from atoma_infer_tpu_torch.tools import qmm_ablation

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        qmm_ablation.run()
