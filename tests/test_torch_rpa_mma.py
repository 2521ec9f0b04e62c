"""The tensor-core ragged paged-attention kernel (kernels A, D and E for bf16
queries: ``rpa_mma_kernel`` in the port's ``csrc/paged_attention_mma.cuh``),
modelled on the CPU.

The CUDA kernel runs only on the card. What can be checked here:
- the byte widening, in a numpy model of the bit operations the kernel uses
  (``widen2``): every int8 byte and every e4m3 byte becomes its bf16 value
  exactly, and the block's widening pass turns a landed tile of raw bytes
  into the bf16 tile of the values the cache means;
- the fragments, in a numpy model of one warp's m16n8k16 ``mma.sync`` with
  the PTX register layouts: Q's A fragments, K's B fragments by
  ``ldmatrix``, P's A fragments built from the score accumulators, V's by
  ``ldmatrix.trans``: the assembled Q·Kᵀ and P·V equal the direct products
  (f32 sums of exact products, rtol 1e-5);
- the kernel's arithmetic, in a numpy model of its blocks: the query tiles
  laid end to end over the batch, the row packing, 64-key tiles gathered
  slot by slot across pages (blocks of 8, 16, 48, 64 and 128), P rounded to
  bf16 after the V scale, the split ranges and the log-sum-exp combine. It
  is held against the plain version (``ragged_paged_attention_paged_plain``)
  and against the JAX package's ``ragged_paged_attention_pallas`` in
  interpret mode on the same seeded numpy inputs, bf16 queries over bf16,
  INT8 + scales and e4m3 caches, D = 32, 64, 128, groups 1, 3, 4, 8, and
  over bf16 caches at D = 96 and 256 (Phi-3-mini, Gemma-2), with a
  sliding window, a soft cap and ALiBi. Tolerance 2e-2 (``ATTN_TOL
  ["bfloat16"]`` of ``chip_smoke.py``): bf16 inputs, the model's and the
  Pallas kernel's P in bf16 against the plain version's f32 P, one rounding
  of the output to bf16;
- the host's split plan (``rpa_mma_plan``): it takes shapes only, every key
  of every row falls in exactly one split, a split can be empty;
- the tile's geometry at every head dim: the copies cover each 16-byte
  piece of a key tile once (at D = 96 too, whose 24 pieces a key do not
  divide the threads), and ``ldmatrix``'s rows meet no bank conflict;
- the width 512's kernel (``rpa_w512_kernel``, ``paged_attention_w512.cuh``):
  Q's fragments from a Q tile in shared memory by ldmatrix equal the
  register-built ones, the 4 warps' column slices of P·V tile the head once
  beside the same S, the 32-key ring's copies, its shared memory, and its
  plan (16-row tiles, groups past 16 in slices);
- the route: bf16 queries take the ``*_mma`` kernels, f32 the CUDA cores.
"""

import inspect

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops.attention import alibi_slopes

from jax_compiled import ragged_paged_attention_pallas
from test_torch_quant_mma import bf16_bits_to_f32, f32_to_bf16_bits, widen_pair
from torch_parity import (
    jax_meta, jax_scale_pages, quantized_case, ragged_case, to_torch, torch_meta, valid_rows,
)

torch.set_num_threads(2)

KT = pa.RPA_KEY_TILE
TOL = 2e-2
KINDS = ("bf16", "int8", "fp8")
LANES = np.arange(32)
G8, C4 = LANES // 4, LANES % 4


# ------------------------------------------------------ the byte widening
def widen2(w, j, kind):
    """``widen2<C>(w, j)``: bytes j and j + 1 of w as a bf16 pair (byte j in
    the low half). int8: ``widen_pair(w, w >> 8, j)``."""
    w = np.asarray(w, np.uint32)
    if kind == "int8":
        return widen_pair(w, w >> 8, j)
    # e4m3x2 → f16x2 (the card's cvt, exact), each half to f32, then one
    # round-to-nearest pack into bf16x2.
    two = (w >> (8 * j)) & 0xFFFF
    lo = (two & 0xFF).astype(np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float16)
    hi = (two >> 8).astype(np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float16)
    return (f32_to_bf16_bits(lo.astype(np.float32))
            | (f32_to_bf16_bits(hi.astype(np.float32)) << 16)).astype(np.uint32)


def byte_values(b, kind):
    """What a cache byte means: int8, or e4m3 (NaN for 0x7F and 0xFF)."""
    b = np.asarray(b, np.uint8)
    if kind == "int8":
        return b.view(np.int8).astype(np.float32)
    return b.view(ml_dtypes.float8_e4m3fn).astype(np.float32)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("lo_byte", [0, 2])
def test_widen2_is_exact_for_every_byte(kind, lo_byte):
    """Every byte value in either position of the pair, with random
    neighbours, widens to its exact value; e4m3 also equals torch's
    float8_e4m3fn → bfloat16 conversion."""
    hi_byte = lo_byte + 1
    rng = np.random.default_rng(lo_byte)
    v = np.arange(256, dtype=np.uint32)
    other = rng.permutation(256).astype(np.uint32)
    noise = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    keep = ~np.uint32((0xFF << (8 * lo_byte)) | (0xFF << (8 * hi_byte)))
    w = (noise & keep) | (v << (8 * lo_byte)) | (other << (8 * hi_byte))
    out = widen2(w, lo_byte, kind)
    lo, hi = bf16_bits_to_f32(out & 0xFFFF), bf16_bits_to_f32(out >> 16)
    want_lo, want_hi = byte_values(v, kind), byte_values(other, kind)
    finite = np.isfinite(want_lo) & np.isfinite(want_hi)  # e4m3 NaN bytes are never stored
    assert finite.sum() >= 252
    np.testing.assert_array_equal(lo[finite], want_lo[finite])
    np.testing.assert_array_equal(hi[finite], want_hi[finite])
    if kind == "fp8":
        torch_bf16 = torch.from_numpy(v.astype(np.uint8)).view(torch.float8_e4m3fn).to(
            torch.bfloat16).view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
        np.testing.assert_array_equal((out & 0xFFFF)[finite], torch_bf16[finite])


# -------------------------------------------- the fragments, one warp's mma
def bf16_bits(x):
    return f32_to_bf16_bits(np.asarray(x, np.float32))


def pack(lo, hi):
    return (bf16_bits(lo) | (bf16_bits(hi) << 16)).astype(np.uint32)


def halves(w):
    w = np.asarray(w, np.uint32)
    return bf16_bits_to_f32(w & 0xFFFF), bf16_bits_to_f32(w >> 16)


def mma(c, a, b0, b1):
    """m16n8k16 bf16 ``mma.sync`` on per-lane registers: a [32, 4], b0/b1
    [32], c [32, 4] f32 (C, then returned D = A·B + C, in f64 then f32)."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (row, col) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = halves(a[:, reg])
        A[G8 + row, 2 * C4 + col] = lo
        A[G8 + row, 2 * C4 + col + 1] = hi
    for reg, k0 in ((b0, 0), (b1, 8)):
        lo, hi = halves(reg)
        B[2 * C4 + k0, G8] = lo
        B[2 * C4 + k0 + 1, G8] = hi
    C = np.zeros((16, 8))
    C[G8, 2 * C4], C[G8, 2 * C4 + 1] = c[:, 0], c[:, 1]
    C[G8 + 8, 2 * C4], C[G8 + 8, 2 * C4 + 1] = c[:, 2], c[:, 3]
    Dm = (A @ B + C).astype(np.float32)
    return np.stack([Dm[G8, 2 * C4], Dm[G8, 2 * C4 + 1], Dm[G8 + 8, 2 * C4],
                     Dm[G8 + 8, 2 * C4 + 1]], axis=1)


def ldmatrix(rows16, trans=False):
    """``ldmatrix.x4`` (``.trans``) of four 8×8 bf16 matrices, ``rows16[i]``
    the 8 rows (each 8 values) lanes 8i .. 8i+7 point at: r[i] per lane."""
    out = np.zeros((32, 4), np.uint32)
    for i, mat in enumerate(rows16):
        mat = np.asarray(mat, np.float32)
        if trans:
            mat = mat.T
        out[:, i] = pack(mat[G8, 2 * C4], mat[G8, 2 * C4 + 1])
    return out


def q_fragments(Q):
    """Q's A fragments [D/16][32, 4], in the mma's k order."""
    D = Q.shape[1]
    frags = []
    for kk in range(D // 16):
        a = np.zeros((32, 4), np.uint32)
        for rr in range(2):
            row = Q[G8 + 8 * rr]
            d_lo, d_hi = kk * 16 + 2 * C4, kk * 16 + 8 + 2 * C4
            a[:, rr] = pack(row[LANES, d_lo], row[LANES, d_lo + 1])
            a[:, 2 + rr] = pack(row[LANES, d_hi], row[LANES, d_hi + 1])
        frags.append(a)
    return frags


def widen_tile(raw, kind):
    """The block's widening pass over a landed tile of raw bytes: each
    16-byte piece (4 words, ``lds128``) becomes 32 bytes of bf16, words
    widened low pair then high pair. Returns the bf16 tile's values."""
    words = raw.reshape(raw.shape[0], -1, 4).astype(np.uint32)
    words = words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16) | (words[..., 3] << 24)
    out = np.zeros(raw.shape, np.float32)
    for w in range(words.shape[1]):
        for half in range(2):
            lo, hi = halves(widen2(words[:, w], 2 * half, kind))
            out[:, 4 * w + 2 * half], out[:, 4 * w + 2 * half + 1] = lo, hi
    return out


def warp_step(Q, K, V, keys):
    """``rpa_warp_step``'s two products for one warp on bf16 K and V tiles
    (its ``keys`` rows, 64 or 16): S = Q·Kᵀ through ldmatrix and the mma,
    then O = P·V for random P through the score accumulators' layout,
    ldmatrix.trans and the mma. Returns (S [16, keys], P, O [16, D])."""
    D = Q.shape[1]
    qf = q_fragments(Q)
    sc = np.zeros((keys // 8, 32, 4), np.float32)
    for p in range(keys // 16):
        for kk in range(D // 16):
            mats = [K[16 * p + (i // 2) * 8 + np.arange(8)][:, kk * 16 + (i % 2) * 8 + np.arange(8)]
                    for i in range(4)]
            b = ldmatrix(mats)
            sc[2 * p] = mma(sc[2 * p], qf[kk], b[:, 0], b[:, 1])
            sc[2 * p + 1] = mma(sc[2 * p + 1], qf[kk], b[:, 2], b[:, 3])
    S = np.zeros((16, keys), np.float32)
    for j in range(keys // 8):
        for e in range(4):
            S[G8 + 8 * (e >> 1), 8 * j + 2 * C4 + (e & 1)] = sc[j][:, e]
    P = np.exp(np.random.default_rng(keys + D).standard_normal((16, keys))).astype(np.float32)
    acc = np.zeros((keys // 8, 32, 4), np.float32)
    for j in range(keys // 8):
        for e in range(4):
            acc[j][:, e] = P[G8 + 8 * (e >> 1), 8 * j + 2 * C4 + (e & 1)]
    o = np.zeros((D // 8, 32, 4), np.float32)
    for qq in range(keys // 16):
        a = np.stack([pack(acc[2 * qq][:, 0], acc[2 * qq][:, 1]),
                      pack(acc[2 * qq][:, 2], acc[2 * qq][:, 3]),
                      pack(acc[2 * qq + 1][:, 0], acc[2 * qq + 1][:, 1]),
                      pack(acc[2 * qq + 1][:, 2], acc[2 * qq + 1][:, 3])], axis=1)
        for mm in range(D // 16):
            mats = [V[16 * qq + (i % 2) * 8 + np.arange(8)][:, 16 * mm + (i // 2) * 8
                                                            + np.arange(8)]
                    for i in range(4)]
            b = ldmatrix(mats, trans=True)
            o[2 * mm] = mma(o[2 * mm], a, b[:, 0], b[:, 1])
            o[2 * mm + 1] = mma(o[2 * mm + 1], a, b[:, 2], b[:, 3])
    O = np.zeros((16, D), np.float32)
    for n in range(D // 8):
        for e in range(4):
            O[G8 + 8 * (e >> 1), 8 * n + 2 * C4 + (e & 1)] = o[n][:, e]
    return S, P, O


def tile_values(rng, kind, D):
    """A landed key tile: the bf16 values the fragments read (through the
    widening pass for a 1-byte cache) and the values the cache means."""
    if kind == "bf16":
        vals = rng.standard_normal((KT, D)).astype(ml_dtypes.bfloat16).astype(np.float32)
        return vals, vals
    if kind == "int8":
        raw = rng.integers(-127, 128, size=(KT, D)).astype(np.int8).view(np.uint8)
    else:
        raw = np.clip(rng.standard_normal((KT, D)) * 50, -448, 448).astype(
            ml_dtypes.float8_e4m3fn).view(np.uint8)
    return widen_tile(raw, kind), byte_values(raw, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D", [32, 64, 128])
def test_fragments_assemble_qk_and_pv(kind, D):
    """One warp's Q·Kᵀ and P·V from the kernel's fragments over a key tile
    equal the direct products over the values the cache holds (the
    widening is exact; products exact, f32 sums: rtol 1e-5)."""
    keys = KT
    rng = np.random.default_rng(D + len(kind))
    Q = rng.standard_normal((16, D)).astype(ml_dtypes.bfloat16).astype(np.float32)
    K_tile, K = tile_values(rng, kind, D)
    V_tile, V = tile_values(rng, kind, D)
    np.testing.assert_array_equal(K_tile, K)
    S, P, O = warp_step(Q, K_tile[:keys], V_tile[:keys], keys)
    want = Q.astype(np.float64) @ K[:keys].T.astype(np.float64)
    np.testing.assert_allclose(S, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want = P.astype(ml_dtypes.bfloat16).astype(np.float64) @ V[:keys].astype(np.float64)
    np.testing.assert_allclose(O, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _by_kind(cases):
    """Each case over a bf16 cache (ids as they were), then over INT8 and
    e4m3 caches (ids ending in the kind)."""
    return ([pytest.param(*c, "bf16", id="-".join(map(str, c))) for c in cases]
            + [pytest.param(*c, kind, id="-".join(map(str, c + (kind,))))
               for kind in ("int8", "fp8") for c in cases])


@pytest.mark.parametrize("D, kind", _by_kind([(96,), (256,)]))
def test_fragments_assemble_qk_and_pv_wide_heads(D, kind):
    """The same at Phi-3-mini's and Gemma-2's head dims (6 and 16 k16
    steps, 12 and 32 n8 tiles of O), over each cache kind (a 1-byte tile
    through the widening pass: 6 and 16 pieces a row)."""
    test_fragments_assemble_qk_and_pv(kind, D)


def rpa_tile_geometry(D, elt=2):
    """``RpaTile``'s bytes: the padded row and the 16-byte pieces of a K
    (or V) row."""
    return D * elt + 16, D * elt // 16


@pytest.mark.parametrize("D, elt", [(32, 2), (64, 2), (96, 2), (128, 2), (256, 2),
                                    (32, 1), (64, 1), (128, 1), (96, 1), (256, 1)])
@pytest.mark.parametrize("warps", [4, 8])
def test_tile_copies_cover_each_piece_once(D, elt, warps):
    """The tile's copies take every (key, 16-byte piece) of a 64-key tile's
    K|V slices exactly once: where a slice's pieces divide the threads,
    thread tid copies piece tid % kPieces of every (NT / kPieces)-th key
    from key tid / kPieces; else (24 pieces a key at D = 96, ``kWalk``)
    pass i's thread tid copies piece c = i·NT + tid of the tile's
    key-major pieces (24 pieces a key at D = 96, 12 in a 1-byte cache: the
    walk either way)."""
    NT = warps * 32
    _, chunks = rpa_tile_geometry(D, elt)
    pieces = 2 * chunks
    assert KT * pieces % NT == 0
    walk = NT % pieces != 0
    assert walk == (D == 96)
    seen = {}
    if walk:
        copies = [((i * NT + tid) // pieces, (i * NT + tid) % pieces)
                  for i in range(KT * pieces // NT) for tid in range(NT)]
    else:
        passes = NT // pieces
        copies = [(tid // pieces + i * passes, tid % pieces)
                  for i in range(KT // passes) for tid in range(NT)]
    for key_piece in copies:
        seen[key_piece] = seen.get(key_piece, 0) + 1
    assert seen == {(k, p): 1 for k in range(KT) for p in range(pieces)}


@pytest.mark.parametrize("D", [32, 64, 96, 128, 256, 512])
def test_ldmatrix_rows_meet_no_bank_conflict(D):
    """``ldmatrix``'s 8 rows of one matrix (16 bytes each, ``kRow`` apart:
    208 bytes at D = 96, 528 at 256) fall on 8 disjoint groups of 4 banks."""
    row, _ = rpa_tile_geometry(D)
    assert row % 16 == 0
    banks = [set(range((r * row // 4) % 32, (r * row // 4) % 32 + 4)) for r in range(8)]
    assert len(set().union(*banks)) == 32


# ------------------- the width 512 (rpa_w512_kernel, paged_attention_w512.cuh)
W512_KT, W512_WARPS, W512_COLS = 32, 4, 128


def q_tile_fragments(Q, kk):
    """Q's A fragments of k step ``kk`` as ``ldmatrix.x4`` reads them from
    the Q tile in shared memory: lane l points at row l % 16, columns
    16 kk + (l // 16)·8, so matrix i is the 8 rows lanes 8i .. 8i+7 point
    at (rows 0-7 or 8-15, the k step's low or high 8 columns)."""
    mats = []
    for i in range(4):
        lanes = np.arange(8 * i, 8 * i + 8)
        mats.append(np.stack([Q[r, c:c + 8] for r, c in zip(lanes % 16,
                                                            16 * kk + (lanes // 16) * 8)]))
    return ldmatrix(mats)


def warp_step_w512(Q, K, V, P, col0, hd):
    """One warp of the width-512 kernel on a 32-key tile: S = Q·Kᵀ over the
    k steps below ``hd`` (Q's fragments from the Q tile by ldmatrix), then
    O += P·V on the warp's 128 columns from ``col0``, skipping those at or
    past ``hd``. Returns (S [16, 32], O [16, 128])."""
    keys = W512_KT
    sc = np.zeros((keys // 8, 32, 4), np.float32)
    for kk in range(-(-hd // 16)):
        a = q_tile_fragments(Q, kk)
        for p in range(keys // 16):
            mats = [K[16 * p + (i // 2) * 8 + np.arange(8)][:, kk * 16 + (i % 2) * 8 + np.arange(8)]
                    for i in range(4)]
            b = ldmatrix(mats)
            sc[2 * p] = mma(sc[2 * p], a, b[:, 0], b[:, 1])
            sc[2 * p + 1] = mma(sc[2 * p + 1], a, b[:, 2], b[:, 3])
    S = np.zeros((16, keys), np.float32)
    for j in range(keys // 8):
        for e in range(4):
            S[G8 + 8 * (e >> 1), 8 * j + 2 * C4 + (e & 1)] = sc[j][:, e]
    acc = np.zeros((keys // 8, 32, 4), np.float32)
    for j in range(keys // 8):
        for e in range(4):
            acc[j][:, e] = P[G8 + 8 * (e >> 1), 8 * j + 2 * C4 + (e & 1)]
    o = np.zeros((W512_COLS // 8, 32, 4), np.float32)
    for qq in range(keys // 16):
        a = np.stack([pack(acc[2 * qq][:, 0], acc[2 * qq][:, 1]),
                      pack(acc[2 * qq][:, 2], acc[2 * qq][:, 3]),
                      pack(acc[2 * qq + 1][:, 0], acc[2 * qq + 1][:, 1]),
                      pack(acc[2 * qq + 1][:, 2], acc[2 * qq + 1][:, 3])], axis=1)
        for mm in range(W512_COLS // 16):
            if col0 + 16 * mm >= hd:
                continue
            mats = [V[16 * qq + (i % 2) * 8 + np.arange(8)][:, col0 + 16 * mm + (i // 2) * 8
                                                            + np.arange(8)]
                    for i in range(4)]
            b = ldmatrix(mats, trans=True)
            o[2 * mm] = mma(o[2 * mm], a, b[:, 0], b[:, 1])
            o[2 * mm + 1] = mma(o[2 * mm + 1], a, b[:, 2], b[:, 3])
    O = np.zeros((16, W512_COLS), np.float32)
    for n in range(W512_COLS // 8):
        for e in range(4):
            O[G8 + 8 * (e >> 1), 8 * n + 2 * C4 + (e & 1)] = o[n][:, e]
    return S, O


@pytest.mark.parametrize("hd, kind", [(512, "bf16"), (320, "int8"), (257, "fp8"),
                                      (511, "bf16")])
def test_w512_fragments_q_from_shared_memory_and_column_slices(hd, kind):
    """At the width 512: Q's A fragments read by ldmatrix from the Q tile
    equal the fragments the narrower kernels build in registers; each of
    the 4 warps computes the same S = Q·Kᵀ over the k steps below the head
    dim (its columns of Q and K past it zero in the tiles), and O = P·V on
    its own 128 columns: the 4 slices tile the head's columns once, equal
    to the direct product (f32 sums of exact products, rtol 1e-5), and
    nothing is computed past the head dim."""
    rng = np.random.default_rng(hd + len(kind))
    Q = rng.standard_normal((16, 512)).astype(ml_dtypes.bfloat16).astype(np.float32)
    Q[:, hd:] = 0
    K_tile, K = (x[:W512_KT] for x in tile_values(rng, kind, 512))
    V_tile, V = (x[:W512_KT] for x in tile_values(rng, kind, 512))
    for x in (K_tile, K, V_tile, V):
        x[:, hd:] = 0
    frags = q_fragments(Q)
    for kk in range(512 // 16):
        np.testing.assert_array_equal(q_tile_fragments(Q, kk), frags[kk])
    P = np.exp(rng.standard_normal((16, W512_KT))).astype(np.float32)
    want_s = Q.astype(np.float64) @ K.T.astype(np.float64)
    want_o = P.astype(ml_dtypes.bfloat16).astype(np.float64) @ V.astype(np.float64)
    O = np.zeros((16, 512), np.float32)
    for w in range(W512_WARPS):
        S, O_w = warp_step_w512(Q, K_tile, V_tile, P, W512_COLS * w, hd)
        np.testing.assert_allclose(S, want_s, rtol=1e-5, atol=1e-5 * np.abs(want_s).max())
        O[:, W512_COLS * w:W512_COLS * (w + 1)] = O_w
    np.testing.assert_allclose(O[:, :hd], want_o[:, :hd], rtol=1e-5,
                               atol=1e-5 * np.abs(want_o).max())
    assert not O[:, -(-hd // 16) * 16:].any()


@pytest.mark.parametrize("elt", [1, 2])
def test_w512_tile_copies_cover_each_piece_once(elt):
    """The width-512 ring's copies: 128 threads over a 32-key stage's K|V
    slices of 2 × 512 elements; thread tid copies piece tid % kPieces of
    every (128 / kPieces)-th key from key tid / kPieces (128 pieces a key
    in 16 bits, one a thread; 64 in a 1-byte cache, two keys a pass):
    every (key, 16-byte piece) once."""
    chunks = 512 * elt // 16
    pieces, threads = 2 * chunks, 128
    assert threads % pieces == 0 and W512_KT * pieces % threads == 0
    passes = threads // pieces
    copies = sorted((tid // pieces + i * passes, tid % pieces)
                    for i in range(W512_KT // passes) for tid in range(threads))
    assert copies == [(k, p) for k in range(W512_KT) for p in range(pieces)]


@pytest.mark.parametrize("elt, scaled", [(2, False), (1, True), (1, False)])
def test_w512_shared_memory_fits_a_block(elt, scaled):
    """``W512Tile``'s dynamic shared memory (3 stages of 32 keys' K and V
    rows of 512 elements + 16 bytes, a 1-byte cache's widened tile, the
    16-row Q tile, INT8 scales, the slot ring) fits a block's 232,448 bytes
    with room for the static scratch; the narrower kernels' ring at this
    width (3 stages of 64 keys) would not, nor their registers (Q's
    fragments and O: 384 a thread, past 255), where this kernel keeps O's
    128 columns a warp in 64."""
    raw_row, row = 512 * elt + 16, 2 * 512 + 16
    smem = (3 * 2 * W512_KT * raw_row + (2 * W512_KT * row if elt == 1 else 0) + 16 * row
            + (3 * W512_KT * 4 if scaled else 0) + 4 * W512_KT * 4)
    assert smem + 64 <= 232448
    assert 3 * 2 * 64 * row > 232448 and 512 // 4 + 512 // 2 > 255
    assert W512_COLS // 8 * 4 == 64


def test_w512_plan_tiles_sixteen_rows():
    """The width-512 plan: 4 warps over one 16-row tile, 16 / G tokens a
    tile, a group past 16 in slices of at most 16 rows (the kernel's
    ``rpa_group_slices`` at one row tile)."""
    for group, tokens, slices in ((1, 16, 1), (2, 8, 1), (4, 4, 1), (12, 1, 1), (16, 1, 1),
                                  (20, 1, 2), (33, 1, 3)):
        plan = pa.rpa_mma_plan(num_seq_slots=8, num_tokens=64, max_q_len=8, max_keys=2048,
                               group=group, num_kv_heads=2, slots=132, split_cols=True)
        assert (plan.warps, plan.tokens, plan.slices) == (4, tokens, slices)
        assert pa.rpa_group_slices(group, 1) == slices


# ---------------------------------------- the kernel's arithmetic, by block
def tile_keys(first_pos, last_pos, window):
    """``rpa_tile_keys``: the first key tile and the number of key tiles."""
    lo = max(0, first_pos - window + 1) if window else 0
    return lo // KT, last_pos // KT + 1 - lo // KT


def split_count(n_tiles, splits, min_tiles=pa.RPA_MIN_TILES):
    """``rpa_split_count``."""
    return max(1, min(splits, -(-n_tiles // min_tiles)))


def split_range(t_lo, n_tiles, nsplit, i):
    return t_lo + n_tiles * i // nsplit, t_lo + n_tiles * (i + 1) // nsplit


def query_tiles(qsl, num_seqs, seq_lens, tokens, num_tokens, num_seq_slots):
    """The blocks of grid x and their query tiles, as the kernel finds them:
    yields (sequence, first token, tokens) for every x that holds one."""
    for x in range(num_tokens // tokens + num_seq_slots):
        seq = [i for i in range(num_seqs)
               if qsl[i] // tokens + i <= x < qsl[i + 1] // tokens + i + 1]
        assert len(seq) <= 1
        if not seq:
            continue
        s = seq[0]
        tok0 = (x - (qsl[s] // tokens + s)) * tokens
        q_len = qsl[s + 1] - qsl[s]
        if tok0 < q_len:
            yield s, tok0, min(tokens, q_len - tok0)


def merge(states):
    """(m, l, O) states of one set of rows merged by log-sum-exp in order:
    weights exp(m_i − max m), 0 for a state that saw no key."""
    if len(states) == 1:
        return states[0]
    mmax = np.max([st[0] for st in states], axis=0)
    w = [np.where(np.isneginf(st[0]), 0, np.exp(st[0] - np.where(np.isneginf(mmax), 0, mmax)))
         for st in states]
    return (mmax, sum(wi * st[1] for wi, st in zip(w, states)),
            sum(wi[:, None] * st[2] for wi, st in zip(w, states)))


def bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def model_attention(case, plan, kind, *, window=None, soft_cap=None, alibi=None):
    """The tensor-core kernel's arithmetic: [T, Hq, D] f32 (rows past the
    batch zero), the output rounded to bf16."""
    q = np.asarray(case["q"], np.float32)
    T, Hq, D = q.shape
    cache = np.asarray(case["kv_cache"]).astype(np.float32)
    nb, bs, row = cache.shape
    Hk = row // (2 * D)
    G = Hq // Hk
    flat = cache.reshape(nb * bs, Hk, 2, D)
    if kind == "int8":
        sc = np.asarray(case["kv_scales"]).astype(np.float32).reshape(nb * bs, 2)
    else:
        sc = np.ones((nb * bs, 2), np.float32)
    qsl, lens, bt = case["query_start_loc"], case["seq_lens"], case["block_tables"]
    S = bt.shape[0]
    win = window or 0
    scale = np.float32(D ** -0.5)
    out = np.zeros((T, Hq, D), np.float32)
    tiles = list(query_tiles(qsl, case["num_seqs"], lens, plan.tokens, T, S))
    for h in range(Hk):
        for s, tok0, ntok in tiles:
            q_len = qsl[s + 1] - qsl[s]
            first = lens[s] - q_len + tok0
            last = first + ntok - 1
            key_lo = max(0, first - win + 1) if win else 0
            r = np.arange(ntok * G)
            ti, gg = r // G, r % G
            Q = q[qsl[s] + tok0 + ti, h * G + gg]
            qpos = first + ti
            slope = (np.zeros(len(r), np.float32) if alibi is None
                     else np.asarray(alibi, np.float32)[h * G + gg])
            t_lo, n_tiles = tile_keys(first, last, win)
            nsplit = split_count(n_tiles, plan.splits)
            parts = []
            for i in range(nsplit):
                tb, te = split_range(t_lo, n_tiles, nsplit, i)
                m = np.full(len(r), -np.inf, np.float32)
                l = np.zeros(len(r), np.float32)
                o = np.zeros((len(r), D), np.float32)
                for t in range(tb, te):
                    keys = t * KT + np.arange(KT)
                    ok = (keys >= key_lo) & (keys <= last)
                    slots = np.where(ok, bt[s, np.minimum(keys // bs, bt.shape[1] - 1)] * bs
                                     + keys % bs, 0)
                    K = np.where(ok[:, None], flat[slots, h, 0], 0).astype(np.float32)
                    V = np.where(ok[:, None], flat[slots, h, 1], 0).astype(np.float32)
                    ks = np.where(ok, sc[slots, 0], 0).astype(np.float32)
                    vs = np.where(ok, sc[slots, 1], 0).astype(np.float32)
                    sco = (Q @ K.T).astype(np.float32) * ks * scale
                    if soft_cap:
                        sco = np.float32(soft_cap) * np.tanh(sco / np.float32(soft_cap))
                    dist = (keys[None, :] - qpos[:, None]).astype(np.float32)
                    sco = sco + slope[:, None] * dist
                    vis = keys[None, :] <= qpos[:, None]
                    if win:
                        vis &= keys[None, :] > qpos[:, None] - win
                    sco = np.where(vis, sco, -np.inf).astype(np.float32)
                    m_new = np.maximum(m, sco.max(axis=1))
                    m_use = np.where(np.isneginf(m_new), 0, m_new).astype(np.float32)
                    alpha = np.exp(m - m_use)
                    p = np.exp(sco - m_use[:, None])
                    l = l * alpha + p.sum(axis=1)
                    o = o * alpha[:, None] + bf16(p * vs) @ V
                    m = m_new
                parts.append((m, l, o))
            m, l, o = merge(parts)  # rpa_combine_kernel, in split order
            res = np.where(l[:, None] > 0, o / np.where(l > 0, l, 1)[:, None], 0)
            out[qsl[s] + tok0 + ti, h * G + gg] = bf16(res)
    return out


def _case(kind, *, group, D, block_size, specs, seed):
    kw = dict(num_q_heads=2 * group, num_kv_heads=2, head_dim=D, block_size=block_size,
              num_blocks=sum(-(-kv // block_size) for _, kv in specs) + 4)
    rng = np.random.default_rng(seed)
    case = (ragged_case(rng, specs, **kw) if kind == "bf16"
            else quantized_case(rng, specs, kind, **kw))
    case["q"] = case["q"].astype(ml_dtypes.bfloat16)
    if kind == "bf16":
        case["kv_cache"] = case["kv_cache"].astype(ml_dtypes.bfloat16)
    # Rows of the block table past a sequence's pages hold garbage.
    bt = case["block_tables"]
    for s, (_, kv) in enumerate(specs):
        pages = -(-kv // block_size)
        bt[s, pages:] = rng.integers(1 << 20, 1 << 24, size=bt.shape[1] - pages)
    return case


def _plain(case, kind, **kw):
    scales = case.get("kv_scales")
    return pa.ragged_paged_attention_paged_plain(
        to_torch(case["q"]), to_torch(case["kv_cache"]), torch_meta(case),
        scale=case["q"].shape[2] ** -0.5, kv_scales=None if scales is None else to_torch(scales),
        **kw).float().numpy()


MIXED = [(20, 45), (1, 30), (7, 7), (1, 1), (33, 200), (1, 300)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_size", [8, 16, 48, 64, 128])
def test_model_matches_plain_across_pages(kind, block_size):
    """Key tiles gathered across pages at every block size, under one split
    and under several, at D = 64 and 4 q heads per kv head."""
    case = _case(kind, group=4, D=64, block_size=block_size, specs=MIXED, seed=block_size)
    n = valid_rows(case)
    want = _plain(case, kind)
    for warps, splits in ((4, 1), (4, 3), (8, 2)):
        plan = pa.RpaPlan(warps, warps * 16 // 4, splits)
        got = model_attention(case, plan, kind)
        np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D, group", [(32, 1), (64, 3), (128, 4), (32, 8)])
@pytest.mark.parametrize("mod", ["none", "window", "soft_cap", "alibi"])
def test_model_matches_plain_and_pallas(kind, D, group, mod):
    """The model against the plain version and JAX's Pallas kernel in
    interpret mode, bf16 queries, with one score modifier at a time."""
    specs = [(24, 24), (1, 90), (9, 130)]
    case = _case(kind, group=group, D=D, block_size=16, specs=specs,
                 seed=D + group + len(mod) + 10 * len(kind))
    Hq = 2 * group
    kw = {"window": dict(sliding_window=40), "soft_cap": dict(soft_cap=5.0),
          "alibi": dict(alibi_slopes=alibi_slopes(Hq)), "none": {}}[mod]
    n = valid_rows(case)
    plan = pa.RpaPlan(4, 64 // group, 2)
    got = model_attention(case, plan, kind, window=kw.get("sliding_window"),
                          soft_cap=kw.get("soft_cap"), alibi=kw.get("alibi_slopes"))
    want = _plain(case, kind, **kw)
    np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)

    scales = case.get("kv_scales")
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    pallas = np.asarray(ragged_paged_attention_pallas(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), jax_meta(case),
        scale=D ** -0.5, interpret=True,
        kv_scales=None if scales is None else jnp.asarray(jax_scale_pages(scales)), **jkw,
    )).astype(np.float32)
    np.testing.assert_allclose(got[:n], pallas[:n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D, group, kind", _by_kind([(96, 1), (96, 2), (256, 2)]))
@pytest.mark.parametrize("mod", ["none", "window", "soft_cap", "alibi"])
def test_model_matches_plain_and_pallas_wide_heads(D, group, kind, mod):
    """The same at Phi-3-mini's head dim (group 1, as Phi-3-mini) and
    Gemma-2's (group 2, as Gemma-2-9B), over a bf16, an INT8 and an e4m3
    cache."""
    test_model_matches_plain_and_pallas(kind, D, group, mod)


# ------------------------------------------------------ the host's split plan
def test_plan_takes_shapes_only():
    """``rpa_mma_plan`` sees host integers (and whether the head dim is
    below its width and whether that width is 512, host bools; past 512 its
    column slices, a host integer), never a tensor (no device read)."""
    params = inspect.signature(pa.rpa_mma_plan).parameters
    assert set(params) == {"num_seq_slots", "num_tokens", "max_q_len", "max_keys", "group",
                           "num_kv_heads", "slots", "padded", "split_cols", "columns"}
    assert all(p.kind == p.KEYWORD_ONLY for p in params.values())


H100_SLOTS = 132 * 2


@pytest.mark.parametrize("S, P, block_size, max_q_len", [
    (1, 128, 16, 256), (8, 128, 16, 200), (32, 128, 16, 300), (64, 16, 16, 1),
    (2, 24, 64, 33), (4, 12, 128, 17), (1, 256, 8, 1), (16, 40, 48, 64),
])
def test_split_plan_covers_every_key_once(S, P, block_size, max_q_len):
    """For random batches of these shapes: the plan is the same whatever the
    sequence lengths (it never reads them), every visible key of every query
    tile falls in exactly one split's key tiles, and the splits past a tile's
    share are empty."""
    rng = np.random.default_rng(S * P + block_size)
    T = 8 * -(-(max_q_len + S) // 8)
    plan = pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=max_q_len,
                           max_keys=P * block_size, group=4, num_kv_heads=8, slots=H100_SLOTS)
    assert 1 <= plan.splits <= pa.RPA_MAX_SPLITS and plan.tokens * 4 == plan.warps * 16
    empty = 0
    for window in (0, 100):
        for _ in range(3):
            q_lens = [max_q_len] + list(rng.integers(1, max_q_len + 1, size=S - 1))
            q_lens = q_lens[:max(1, min(S, T // max_q_len))]
            kv = [int(rng.integers(q, P * block_size + 1)) for q in q_lens]
            qsl = np.concatenate([[0], np.cumsum(q_lens)]).astype(int)
            for s, tok0, ntok in query_tiles(qsl, len(q_lens), kv, plan.tokens, T, S):
                first = kv[s] - q_lens[s] + tok0
                last = first + ntok - 1
                t_lo, n_tiles = tile_keys(first, last, window)
                nsplit = split_count(n_tiles, plan.splits)
                covered = []
                for i in range(plan.splits):
                    if i >= nsplit:
                        empty += 1
                        continue
                    tb, te = split_range(t_lo, n_tiles, nsplit, i)
                    assert te > tb
                    covered += [k for t in range(tb, te) for k in range(t * KT, t * KT + KT)]
                lo = max(0, first - window + 1) if window else 0
                visible = [k for k in covered if lo <= k <= last]
                assert sorted(visible) == list(range(lo, last + 1))
                assert len(covered) == len(set(covered))
    if plan.splits > 1:
        assert empty > 0


def test_split_heuristic_is_fa2s():
    """Full grids take one split; a small grid takes the fewest splits
    within 85% of the best wave efficiency."""
    assert pa.num_splits_heuristic(300, 264, 16, 16) == 1
    assert pa.num_splits_heuristic(128, 264, 16, 16) == 2
    assert pa.num_splits_heuristic(8, 264, 16, 16) == 16
    assert pa.num_splits_heuristic(8, 264, 1, 16) == 1


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("kind", [None, torch.int8, torch.float8_e4m3fn])
def test_route_bf16_to_tensor_cores_f32_to_cuda_cores(kind):
    q16 = torch.zeros(8, 4, 64, dtype=torch.bfloat16)
    assert pa.ragged_route(q16, kind) is pa.RAGGED_ATTENTION_MMA[kind]
    assert pa.ragged_route(q16.float(), kind) is pa.RAGGED_ATTENTION[kind]
    assert pa.RAGGED_ATTENTION_MMA[kind].name.endswith("_mma")
    assert pa.RAGGED_ATTENTION_MMA[kind].source == (
        pa.RAGGED_ATTENTION[kind].source.replace(".cu", "_mma.cu"))


@pytest.mark.parametrize("group, max_q_len, seqs, warps", [
    (4, 1, 8, 4), (4, 127, 8, 4), (4, 128, 8, 8), (4, 256, 16, 4), (1, 511, 8, 4),
    (1, 512, 8, 8), (64, 1, 8, 4), (65, 1, 64, 8),
])
def test_rpa_warps(group, max_q_len, seqs, warps):
    """128-row tiles for a long chunk in a step of few sequences, or a group
    past 64; else 64."""
    assert pa.rpa_warps(group, max_q_len, seqs) == warps


def test_rpa_warps_refuses_a_group_past_one_tile():
    """A group past one tile's 128 rows is no longer refused: it takes 8
    warps, and the plan cuts a token's group into two slices of 65 and 64
    q heads, one token a tile."""
    assert pa.rpa_warps(129, 1, 8) == 8
    assert pa.rpa_group_slices(129, 8) == 2
    plan = pa.rpa_mma_plan(num_seq_slots=8, num_tokens=8, max_q_len=1, max_keys=2048,
                           group=129, num_kv_heads=1, slots=264)
    assert (plan.warps, plan.tokens, plan.slices) == (8, 1, 2)
