"""Kernel H on the int8 tensor cores (``qmm_w8a8_mma_kernel`` in the port's
``csrc/quant_matmul.cu``), modelled on the CPU.

The CUDA kernel runs only on the card. What can be checked here:
- the int4 nibbles' unbiasing (``__vsub4`` of the low or high nibbles
  against 8) over every nibble value, whatever the byte's other nibble;
- the ``mma.sync.m16n8k32.s8`` fragments, in a numpy model of the PTX
  register layouts: A from the int8 x tile through the ``ldmatrix`` lane
  map, B from the raw ``[K, N]`` weight tile through the column map and
  ``transpose4x4``: over one group of 128 k the model's int32 dots equal
  ``xq @ q`` exactly, for int8 and int4 weights; the int4 low nibbles pair
  with the group's first half of x columns and the high ones with its
  second half;
- the kernel's data flow, in a numpy model of its blocks (copies into the
  swizzled ring, the 32-row weight steps, the group ends, the K splits and
  ``split_reduce_kernel``'s order): with unit scales the f32 outputs are
  the exact integer products; with the real scales the output is within
  1e-5 of the plain version's largest value (an fma against a multiply and
  add, f32 sums in another order);
- the route and plan function ``w8a8_launch`` at M in 1, 8, 64, 256, 300,
  groups of 32 to 512 and ragged N, with an H100's occupancy;
- the plain version against the JAX package's W8A8 (``ATOMA_W8A8``, its
  Pallas kernel in interpret mode) at the route's new shapes: groups of 32,
  64 and 256, M = 17 and 256, within one bf16 ulp of the output (2^-7 of
  the largest value, as ``test_torch_quant.py`` holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu.ops import quant as jquant
from atoma_infer_tpu_torch.ops import quant, quant_kernels as qk

from test_torch_quant_mma import GID, LANE, TIG, _u32, byte_perm

torch.set_num_threads(2)

BN = 128  # kMmaBN
M_TILES_WARPS = {16: (1, 1), 32: (2, 1), 64: (4, 1), 128: (4, 2)}  # block rows -> (MT, WM)
# The blocks of kernel H's tensor-core route an H100 SM holds at once, by
# bits and block rows: the occupancy calculator's answer
# (``atoma_qmm_w8a8_mma_blocks_per_sm``) for the build PERF.md measured,
# given here as the card gives it.
H100_W8A8_BLOCKS_PER_SM = {8: {16: 3, 32: 3, 64: 2, 128: 1}, 4: {16: 3, 32: 3, 64: 2, 128: 1}}
H100_SMS = 132


def h100_w8a8_slots(bits, block_rows):
    return H100_W8A8_BLOCKS_PER_SM[bits][block_rows] * H100_SMS


# ------------------------------------------------------ the instructions, in numpy
def vsub4(a, b):
    """``__vsub4``: per-byte subtraction modulo 256."""
    a, b = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
    out = np.zeros(np.broadcast(a, b).shape, np.uint32)
    for k in range(4):
        d = (((a >> (8 * k)) & 0xFF) - ((b >> (8 * k)) & 0xFF)) & 0xFF
        out |= d.astype(np.uint32) << (8 * k)
    return out


def unbias_nibbles(w, high):
    """``unbias_nibbles`` of ``csrc/quant_matmul.cu``."""
    w = np.asarray(w, np.uint32)
    return vsub4(((w >> 4) if high else w) & 0x0F0F0F0F, 0x08080808)


def transpose4x4(r):
    """``transpose4x4`` of ``csrc/mma_sm90.cuh``: words r[0..3] (row i's 4
    column bytes) → t[0..3] (column j's 4 row bytes, row 0 lowest)."""
    x0, x1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    y0, y1 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(x0, y0, 0x5410), byte_perm(x0, y0, 0x7632),
            byte_perm(x1, y1, 0x5410), byte_perm(x1, y1, 0x7632)]


def s8_bytes(words):
    """[lanes] uint32 → [lanes, 4] int8 (byte 0 first)."""
    return np.asarray(words, np.uint32).view(np.uint8).reshape(-1, 4).view(np.int8)


@pytest.mark.parametrize("high", [0, 1])
def test_unbias_nibbles_every_value(high):
    n = np.repeat(np.arange(16, dtype=np.uint32), 16)  # the nibble unbiased
    other = np.tile(np.arange(16, dtype=np.uint32), 16)  # the byte's other nibble
    byte = (n << 4 | other) if high else (other << 4 | n)
    rng = np.random.default_rng(high)
    for k in range(4):  # the byte's place in its word
        words = rng.integers(0, 2**32, size=byte.shape, dtype=np.uint64).astype(np.uint32)
        words = (words & ~np.uint32(0xFF << (8 * k))) | (byte << (8 * k))
        got = s8_bytes(unbias_nibbles(words, high))[:, k].astype(np.int32)
        np.testing.assert_array_equal(got, n.astype(np.int32) - 8)


def test_transpose4x4_gives_columns():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2**32, size=(4, 32), dtype=np.uint64).astype(np.uint32)
    t = transpose4x4(rows)
    for j in range(4):
        for i in range(4):
            np.testing.assert_array_equal((t[j] >> (8 * i)) & 0xFF, (rows[i] >> (8 * j)) & 0xFF)


# ------------------------------------------------- the kernel's data flow, in numpy
def _load_tile(xb, qb, sb, *, bits, rg, M, N, m0, n0, r0, r_end, bm):
    """A stage's bytes as ``load_tile`` writes them: x sub-tiles (one for
    int8, low and high partners for int4), the 128-row weight tile, the
    scale slots; chunks swizzled, what is out of range zero."""
    subs = 1 if bits == 8 else 2
    xt = np.zeros(subs * bm * 128, np.uint8)
    wt = np.zeros(128 * 128, np.uint8)
    st = np.zeros(4 * 2 * BN, np.uint8)
    for r in range(128):
        for cc in range(8):
            if r0 + r < r_end and n0 + 16 * cc < N:
                dst = r * 128 + ((cc ^ (((r >> 2) & 3) << 1)) << 4)
                wt[dst:dst + 16] = qb[r0 + r, n0 + 16 * cc:n0 + 16 * cc + 16]
    for cc in range(8):
        step = cc >> 1
        rs = r0 + 16 * cc  # the chunk's first weight row (int8 k, or packed int4 row)
        for h in range(subs):
            xcol = rs if bits == 8 else rs + ((r0 + 32 * step) // rg + h) * rg
            for r in range(bm):
                if r0 + 32 * step < r_end and m0 + r < M:
                    dst = (h * bm + r) * 128 + ((cc ^ (r & 7)) << 4)
                    xt[dst:dst + 16] = xb[m0 + r, xcol:xcol + 16]
    for s in range(4):
        rr = r0 + 32 * s
        if rr < r_end and (rr + 32) % rg == 0:
            for c in range(16):
                if n0 + 8 * c < N:
                    st[s * 2 * BN + 16 * c:s * 2 * BN + 16 * c + 16] = \
                        sb[rr // rg, 2 * (n0 + 8 * c):2 * (n0 + 8 * c) + 16]
    return xt, wt, st


def a_fragment_s8(xt, addr):
    """ldmatrix.x4 at per-lane 16-byte row addresses (lanes 8i..8i+7 give
    matrix i's rows; lane t receives bytes 4 (t % 4) .. + 3 of row t / 4 of
    each matrix), then the m16n8k32 s8 A layout of those registers: a0 row
    gid k 4 tig + e, a1 row gid + 8, a2 row gid k 16 + 4 tig + e, a3 row
    gid + 8 k 16 + .... Returns A int [16, 32]."""
    mats = np.stack([xt[b:b + 16] for b in addr]).reshape(4, 8, 16)
    regs = [mats[i][GID, :].reshape(32, 4, 4)[LANE, TIG].view(np.int8) for i in range(4)]
    a = np.zeros((16, 32), np.int64)
    for reg, (r, k) in zip(regs, ((0, 0), (8, 0), (0, 16), (8, 16))):
        for e in range(4):
            a[r + GID, k + 4 * TIG + e] = reg[:, e]
    return a


def b_fragment_s8(b0, b1):
    """The m16n8k32 s8 B layout: lane (gid, tig) holds B[4 tig + e, gid] in
    byte e of b0 and B[16 + 4 tig + e, gid] in byte e of b1. Returns B int
    [32, 8]."""
    b = np.zeros((32, 8), np.int64)
    for reg, k in ((b0, 0), (b1, 16)):
        v = s8_bytes(reg)
        for e in range(4):
            b[k + 4 * TIG + e, GID] = v[:, e]
    return b


def w8a8_model(xq, qweight, scales, act, *, bits, group_size, out_dtype=torch.float32,
               dots=None):
    """Kernel H's tensor-core result, modelled pass by pass; returns an
    [M, N] tensor of ``out_dtype``. ``dots``, if a list, receives each
    completed group's int32 dots with their rows and columns."""
    M, K = xq.shape
    N = qweight.shape[1]
    G = group_size
    rg = G if bits == 8 else G // 2
    passes = 4 if bits == 8 else 8
    block_rows, gps, splits = qk.mma_plan(M, N, K // G,
                                          h100_w8a8_slots(bits, qk.mma_block_rows(M)))
    mt, wm_n = M_TILES_WARPS[block_rows]
    xb = xq.numpy().view(np.uint8)
    qb = qweight.numpy().view(np.uint8)
    sb = scales.view(torch.int16).numpy().view(np.uint8)
    ws = np.zeros((splits, M, N), np.float32)
    for z in range(splits):
        r_begin, r_end = z * gps * rg, min(K // G, (z + 1) * gps) * rg
        for m0 in range(0, M, block_rows):
            for n0 in range(0, N, BN):
                tiles = [(r0, _load_tile(xb, qb, sb, bits=bits, rg=rg, M=M, N=N, m0=m0, n0=n0,
                                         r0=r0, r_end=r_end, bm=block_rows))
                         for r0 in range(r_begin, r_end, 128)]
                for warp in range(4 * wm_n):
                    wn, wm = (warp & 3) * 32, (warp >> 2) * 16 * mt
                    acc = np.zeros((mt, 4, 16, 8), np.int64)
                    tot = np.zeros((mt, 4, 16, 8), np.float32)
                    for r0, (xt, wt, st) in tiles:
                        valid = min(4, (r_end - r0) // 32)
                        b_off = (4 * TIG * 128 + (((wn // 16 + (GID >> 2)) ^ (TIG << 1)) << 4)
                                 + 4 * (GID & 3))
                        for u in range(passes):
                            s, h = (u, 0) if bits == 8 else (u >> 1, u & 1)
                            last = bits == 8 or bool(u & 1)
                            if s >= valid:
                                continue
                            base = b_off + 32 * s * 128
                            t0 = transpose4x4([_u32(wt, base + i * 128) for i in range(4)])
                            t1 = transpose4x4([_u32(wt, base + (16 + i) * 128) for i in range(4)])
                            chunk = ((2 * s + (LANE >> 4)) ^ (LANE & 7)) << 4
                            for mi in range(mt):
                                rows = h * block_rows + wm + 16 * mi + (LANE & 15)
                                a = a_fragment_s8(xt, rows * 128 + chunk)
                                for j in range(4):
                                    b0, b1 = t0[j], t1[j]
                                    if bits == 4:
                                        b0, b1 = unbias_nibbles(b0, h), unbias_nibbles(b1, h)
                                    acc[mi, j] += a @ b_fragment_s8(b0, b1)
                            assert np.abs(acc).max() < 2**31  # int32 accumulators
                            rr = r0 + 32 * s
                            if last and (rr + 32) % rg == 0:
                                if dots is not None:
                                    dots.append((m0 + wm, n0 + wn, rr // rg, acc.copy()))
                                sc = (st[s * 2 * BN:(s + 1) * 2 * BN].view(np.uint16)
                                      .astype(np.uint32) << 16).view(np.float32)
                                for j in range(4):
                                    # logical column n is physical column wn + 4 n + j
                                    scale = sc[wn + 4 * np.arange(8) + j]
                                    prod = acc[:, j].astype(np.float32).astype(np.float64) * scale
                                    tot[:, j] = (prod + tot[:, j]).astype(np.float32)  # fmaf
                                acc[:] = 0
                    for mi in range(mt):
                        for j in range(4):
                            for n in range(8):
                                col = n0 + wn + 4 * n + j
                                rows = m0 + wm + 16 * mi + np.arange(16)
                                keep = rows < M
                                if col < N:
                                    ws[z, rows[keep], col] = tot[mi, j, keep, n]
    a = act.reshape(-1, 1).numpy().astype(np.float32)
    if splits == 1:  # the epilogue's token scale
        return torch.from_numpy(ws[0] * a).to(out_dtype)
    out = np.zeros((M, N), np.float32)
    for z in range(splits):  # split_reduce_kernel's fixed order, then the token scale
        out = (out + ws[z]).astype(np.float32)
    return torch.from_numpy(out * a).to(out_dtype)


def _case(bits, K, N, group, M, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    xq, act = qk.quantize_activations(x)
    return xq, act, quant.quantize_weight(w, bits, group)


def _full_weight(qt, bits, group):
    q = quant._unpack_int4(qt.qweight, group) if bits == 4 else qt.qweight
    return q.numpy().astype(np.int64)


@pytest.mark.parametrize("bits", [8, 4])
def test_fragments_give_exact_group_dots(bits):
    """One group of 128 k: every int32 dot the model completes equals the
    integer product of its rows and columns."""
    xq, act, qt = _case(bits, 128, 128, 128, 16, seed=bits)
    dots = []
    w8a8_model(xq, qt.qweight, qt.scales, act, bits=bits, group_size=128, dots=dots)
    want = xq.numpy().astype(np.int64) @ _full_weight(qt, bits, 128)
    assert len(dots) == 4  # one group, 4 warps of 32 columns
    for row0, col0, g, acc in dots:
        assert g == 0
        for j in range(4):
            for n in range(8):
                np.testing.assert_array_equal(acc[0, j, :, n], want[row0:row0 + 16, col0 + 4 * n + j])


def test_int4_halves_pair_with_their_x_columns():
    """INT4 packed row r of a group holds row r (low nibble) and row r + G/2
    (high nibble): a weight whose low rows are zero and high rows are not
    (and the reverse) gives the product with the matching half of x only."""
    G, K, N, M = 128, 256, 128, 5
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, size=(M, K)).astype(np.int8))
    ones = torch.ones(M, 1)
    for zero_half in (0, 1):
        q = rng.integers(-7, 8, size=(K, N)).astype(np.int64)
        rows = np.arange(K) % G
        q[(rows < G // 2) if zero_half == 0 else (rows >= G // 2)] = 0
        q[(G // 2) * (1 - zero_half)::G] = 7  # every group column's absmax 7: unit scales
        w = torch.from_numpy(q.astype(np.float32))
        qt = quant.quantize_weight(w, 4, G)
        assert np.array_equal(_full_weight(qt, 4, G), q)  # max 7 per column: unit scales
        got = w8a8_model(xq, qt.qweight, torch.ones_like(qt.scales), ones, bits=4, group_size=G)
        want = xq.numpy().astype(np.int64) @ q
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# (K, N, group, M): decode blocks, a partial column block (N = 144), groups
# of 32 and 64 (several a tile; INT8 steps end groups mid-tile), one group,
# K splits (groups spread over many blocks), and blocks of 32, 64 and 128
# rows with rows past M.
SHAPES = [
    (8, 256, 128, 128, 1),
    (8, 256, 144, 32, 8),
    (8, 384, 256, 64, 20),
    (8, 128, 128, 128, 64),
    (8, 512, 128, 32, 130),
    (4, 256, 128, 128, 3),
    (4, 256, 144, 64, 16),
    (4, 512, 128, 512, 17),
    (4, 384, 128, 64, 40),
    (4, 256, 128, 128, 129),
]


@pytest.mark.parametrize("bits, K, N, group, M", SHAPES)
def test_model_dots_are_exact_with_unit_scales(bits, K, N, group, M):
    xq, act, qt = _case(bits, K, N, group, M, seed=K + N + M + bits)
    got = w8a8_model(xq, qt.qweight, torch.ones_like(qt.scales), torch.ones(M, 1), bits=bits,
                     group_size=group)
    want = xq.numpy().astype(np.int64) @ _full_weight(qt, bits, group)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("bits, K, N, group, M", SHAPES)
def test_model_matches_plain(bits, K, N, group, M):
    xq, act, qt = _case(bits, K, N, group, M, seed=2 * K + N + M + bits)
    want = qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act, bits=bits, group_size=group,
                                out_dtype=torch.float32).numpy()
    got = w8a8_model(xq, qt.qweight, qt.scales, act, bits=bits, group_size=group).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


# ------------------------------------------------------- the route and the plan
def _operands(M, K, N, bits, group, offset=None):
    """Uninitialised operands of one call; ``offset`` names the one tensor
    placed off 16-byte alignment (a view 1 element into a larger tensor)."""
    def alloc(shape, dt, name):
        n = int(np.prod(shape))
        if offset != name:
            return torch.empty(shape, dtype=dt)
        return torch.empty(n + 16, dtype=dt)[1:1 + n].view(shape)

    xq = alloc((M, K), torch.int8, "xq")
    q = alloc((K // (2 if bits == 4 else 1), N), torch.int8, "q")
    s = alloc((K // group, N), torch.bfloat16, "scales")
    return xq, q, s


@pytest.mark.parametrize("M", [1, 8, 64, 256, 300])
@pytest.mark.parametrize("bits, group", [(8, 32), (8, 64), (8, 128), (8, 512), (4, 32), (4, 64),
                                         (4, 128), (4, 512)])
@pytest.mark.parametrize("N", [1024, 14336, 200, 72])
def test_route_and_plan(M, bits, group, N, monkeypatch):
    asked = []
    monkeypatch.setattr(qk, "_w8a8_mma_slots",
                        lambda b, rows, device: asked.append((b, rows)) or h100_w8a8_slots(b, rows))
    K = 4096
    xq, q, s = _operands(M, K, N, bits, group)
    launch = qk.w8a8_launch(xq, q, s, bits=bits, group_size=group)
    takes = N % 16 == 0 and group % (32 if bits == 8 else 64) == 0
    groups = K // group
    if takes:
        assert launch.kernel is qk.QMM_W8A8_MMA
        block_rows, gps = launch.geometry
        assert block_rows == qk.mma_block_rows(M) and asked == [(bits, block_rows)]
        splits = -(-groups // gps)
        assert launch.workspace == ((splits, M, N) if splits > 1 else None)
        blocks = -(-N // BN) * -(-M // block_rows)
        # F and G's plan against H's own occupancy: one wave of resident
        # blocks, K split in whole groups only while the grid has room.
        slots = h100_w8a8_slots(bits, block_rows)
        assert (block_rows, gps, splits) == qk.mma_plan(M, N, groups, slots)
        assert splits == 1 or blocks * splits <= slots
    else:
        assert launch.kernel is qk.QMM_W8A8 and asked == []
        vec, ks, rsplit, gps, splits = qk._cuda_core_geometry(M, N, groups, q)
        assert launch.geometry == (vec, ks, rsplit, gps)
        assert launch.workspace == ((splits, M, N) if splits > 1 else None)


@pytest.mark.parametrize("offset", ["xq", "q", "scales"])
def test_misaligned_operands_take_the_cuda_cores(offset, monkeypatch):
    monkeypatch.setattr(qk, "_w8a8_mma_slots", lambda b, rows, device: h100_w8a8_slots(b, rows))
    xq, q, s = _operands(8, 256, 256, 8, 128, offset=offset)
    assert not qk.w8a8_mma_takes(xq, q, s, bits=8, group_size=128)
    assert qk.w8a8_launch(xq, q, s, bits=8, group_size=128).kernel is qk.QMM_W8A8


def test_group_size_limit_is_checked():
    K, G = 2 * qk.W8A8_MAX_GROUP, 2 * qk.W8A8_MAX_GROUP
    xq = torch.zeros(1, K, dtype=torch.int8)
    q = torch.zeros(K, 16, dtype=torch.int8)
    s = torch.ones(1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="overflow"):
        qk.w8a8_matmul_cuda(xq, q, s, torch.ones(1, 1), bits=8, group_size=G,
                            out_dtype=torch.float32)


# --------------------------------------------- the plain version against JAX
@pytest.mark.parametrize("M", [17, 256])
@pytest.mark.parametrize("bits, group", [(8, 32), (8, 64), (8, 256), (4, 64), (4, 256)])
def test_plain_matches_jax_w8a8_pallas_interpret(bits, group, M, monkeypatch):
    from atoma_infer_tpu.ops import quant_kernels as jkernels

    rng = np.random.default_rng(7 * M + group + bits)
    w = (rng.standard_normal((256, 256)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    jq = jquant.quantize_weight(jnp.asarray(w), bits, group)
    pq = quant.quantize_weight(torch.from_numpy(w), bits, group)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    monkeypatch.setattr(jkernels, "_W8A8", True)
    want = jkernels.quantized_matmul_pallas(xj, jq.qweight, jq.scales, bits=bits,
                                            group_size=group, interpret=True)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    xq, act = qk.quantize_activations(xt)
    got = qk.w8a8_matmul_plain(xq, pq.qweight, pq.scales, act, bits=bits, group_size=group,
                               out_dtype=torch.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7,
                               atol=2.0**-8 * scale + 1e-6 * scale)


# ------------------------------------------------------- the ablation tool
def test_qmm_ablation_w8a8_needs_a_card():
    from atoma_infer_tpu_torch.tools import qmm_ablation

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        qmm_ablation.run_w8a8()


def test_qmm_ablation_w8a8_plans_cover_the_route():
    """The sweep's plans hold every block-row size the route can pick and a
    split count from one to one group a split."""
    from atoma_infer_tpu_torch.tools import qmm_ablation

    assert {qk.mma_block_rows(m) for m in (1, 17, 33, 65)} == set(qmm_ablation.H_BLOCK_ROWS)
    groups = qmm_ablation.K // qmm_ablation.GROUP
    assert min(qmm_ablation.H_SPLITS) == 1 and max(qmm_ablation.H_SPLITS) == groups
