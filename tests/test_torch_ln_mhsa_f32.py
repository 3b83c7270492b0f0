"""The fp32 GEMM and the LayerNorm of ``csrc/ln_mhsa.cu`` spelled out in
Python and held against their plain versions.

No compiler runs here, so these mirrors are the CPU's check of the kernels'
design: which block computes which tile, which thread which outputs, where
each copy lands in shared memory and that the reads the header calls
conflict-free are, and the LayerNorm's lane partition and reduction order.
The kernels' constants are read from the source, so the mirrors follow it.
"""

import re

import numpy as np
import pytest
import torch

from prpe_tpu_torch.ops.kernels import _build
from prpe_tpu_torch.ops.kernels.ln_mhsa import (
    _LN_MAX_BYTES, _check_row_width, layernorm_plain, linear_plain,
)

SRC = (_build.CSRC / "ln_mhsa.cu").read_text()


def const(name: str) -> int:
    """A ``constexpr int`` of the source."""
    return int(re.search(rf"^constexpr int [^;]*\b{name} = (\d+)\b", SRC, re.M).group(1))


CG, TM, TN, FK = const("kCG"), const("kTM"), const("kTN"), const("kFK")
THREADS, BLOCKS, STAGES = const("kFThreads"), const("kFBlocks"), const("kFStages")
RG = THREADS // CG
FM, FN = RG * TM, CG * TN
FC = FK // 4  # 16-byte chunks a tile row
ROWS = THREADS // FC  # tile rows one pass of copies fills
SMS = 132  # H100 SXM

# (m, n, parts): ViT-B's GEMMs at B = 32 and 128, then the odd shapes of
# chip_smoke.py (half-blocks and stages alone)
SERVING = [(32 * 192, 768, 3), (32 * 192, 768, 1), (128 * 192, 768, 3), (128 * 192, 768, 1)]
ODD = [(2 * 24, 32, 3), (3 * 10, 64, 3), (2 * 65, 64, 3), (1 * 200, 96, 3), (3 * 77, 256, 3),
       (3 * 77, 96, 1), (1 * 200, 256, 1), (2 * 65, 40, 1)]


# ------------------------------------------------------------ GEMM mirror

def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid(m: int, n: int, parts: int):
    return parts * cdiv(n, FN), cdiv(m, FM)


def block_tile(bx: int, by: int, n: int):
    """(part, m0, n0) of block (bx, by), as ``gemm_f32_kernel`` decodes it."""
    ntn = cdiv(n, FN)
    z = bx // ntn
    return z, by * FM, (bx - z * ntn) * FN


def thread_coords(tid: int):
    lane, warp = tid % 32, tid // 32
    return lane // 8 + 4 * (warp // (CG // 8)), lane % 8 + 8 * (warp % (CG // 8))  # ty, tx


def thread_outputs(tid: int):
    """(row, column) in the block tile of each of the thread's accumulators."""
    ty, tx = thread_coords(tid)
    return [(ty + RG * i, 4 * tx + 4 * CG * jj + e)
            for i in range(TM) for jj in range(TN // 4) for e in range(4)]


def w_at(r: int, c: int) -> int:
    """Float offset of chunk c of row r in a stage's w tile."""
    q = FC * r + c
    return 4 * ((q & ~7) | ((q & 7) ^ ((r >> 2) & 7)))


def w_read(tid: int, jj: int, e: int, c: int) -> int:
    """The inner loop's w read, as the kernel writes the address."""
    _, tx = thread_coords(tid)
    q = FC * e + c
    return 4 * FK * tx + 4 * FK * CG * jj + 4 * ((q & ~7) | ((q & 7) ^ (tx & 7)))


def a_read(tid: int, i: int, c: int) -> int:
    ty, _ = thread_coords(tid)
    return FK * ty + FK * RG * i + 4 * c


def copies(tid: int):
    """(tile, row, chunk, float offset) of each 16-byte copy of one stage."""
    cr, cc = tid // FC, tid % FC
    out = [("a", cr + ROWS * p, cc, FK * (cr + ROWS * p) + 4 * cc) for p in range(FM // ROWS)]
    out += [("w", cr + ROWS * p, cc, w_at(cr + ROWS * p, cc)) for p in range(FN // ROWS)]
    return out


def slot(offset: int) -> int:
    """The 16-byte bank group (of eight) a float offset falls in."""
    return (offset * 4 // 16) % 8


@pytest.mark.parametrize("m,n,parts", SERVING + ODD)
def test_blocks_cover_every_tile_once(m, n, parts):
    gx, gy = grid(m, n, parts)
    assert gy <= 65535
    tiles = [block_tile(bx, by, n) for by in range(gy) for bx in range(gx)]
    assert len(tiles) == len(set(tiles))
    assert set(tiles) == {(z, rt * FM, ct * FN) for z in range(parts)
                          for rt in range(cdiv(m, FM)) for ct in range(cdiv(n, FN))}
    # in launch order (x fastest) the blocks of one row block come together
    assert [t[1] for t in tiles] == sorted(t[1] for t in tiles)


def test_serving_tile_counts_and_waves():
    """The tile counts and waves the source header states."""
    counts = {(m, parts): grid(m, n, parts)[0] * grid(m, n, parts)[1]
              for m, n, parts in SERVING}
    assert (FM, FN) == (96, 128)
    assert counts == {(6144, 3): 1152, (6144, 1): 384, (24576, 3): 4608, (24576, 1): 1536}
    waves = {k: round(v / (BLOCKS * SMS), 2) for k, v in counts.items()}
    assert waves == {(6144, 3): 4.36, (6144, 1): 1.45, (24576, 3): 17.45, (24576, 1): 5.82}


def test_threads_cover_the_block_tile_once():
    outs = [o for tid in range(THREADS) for o in thread_outputs(tid)]
    assert len(outs) == len(set(outs)) == FM * FN
    assert set(outs) == {(r, c) for r in range(FM) for c in range(FN)}
    for tid in range(THREADS):  # 16-byte stores: four neighbouring columns, aligned
        cols = [c for _, c in thread_outputs(tid)[:TN]]
        assert all(cols[4 * q] % 4 == 0 and cols[4 * q:4 * q + 4] == list(range(
            cols[4 * q], cols[4 * q] + 4)) for q in range(TN // 4))


def test_copies_fill_a_stage_once():
    got = [cp for tid in range(THREADS) for cp in copies(tid)]
    a = {(r, c) for t, r, c, _ in got if t == "a"}
    w = {(r, c) for t, r, c, _ in got if t == "w"}
    assert len(got) == (FM + FN) * FC
    assert a == {(r, c) for r in range(FM) for c in range(FC)}
    assert w == {(r, c) for r in range(FN) for c in range(FC)}
    # w_at places the w tile's chunks on its floats, one chunk a slot
    assert sorted(w_at(r, c) for r in range(FN) for c in range(FC)) == list(range(0, FK * FN, 4))
    assert sorted(off for t, *_, off in got if t == "a") == list(range(0, FK * FM, 4))


def test_inner_loop_reads_the_layout():
    """The kernel's inlined w address is w_at of row 4 tx + 4 kCG jj + e, and
    the a address is chunk c of row ty + kRG i."""
    for tid in range(THREADS):
        ty, tx = thread_coords(tid)
        for c in range(FC):
            for jj in range(TN // 4):
                for e in range(4):
                    assert w_read(tid, jj, e, c) == w_at(4 * tx + 4 * CG * jj + e, c)
            for i in range(TM):
                assert a_read(tid, i, c) == FK * (ty + RG * i) + 4 * c


def test_shared_memory_is_conflict_free():
    """Each quarter warp of a 16-byte access touches every bank group at
    most once, or reads one address (a broadcast): the w reads, the a reads
    and the copies' writes. Unswizzled, the w reads would conflict 8-way."""
    plain = []
    for q0 in range(0, THREADS, 8):
        lanes = range(q0, q0 + 8)
        for c in range(FC):
            for jj in range(TN // 4):
                for e in range(4):
                    assert len({slot(w_read(t, jj, e, c)) for t in lanes}) == 8
                    rows = [4 * thread_coords(t)[1] + 4 * CG * jj + e for t in lanes]
                    plain.append(len({slot(FK * r + 4 * c) for r in rows}))
            for i in range(TM):
                assert len({a_read(t, i, c) for t in lanes}) == 1
        for p in range(len(copies(0))):
            assert len({slot(copies(t)[p][3]) for t in lanes}) == 8
    assert set(plain) == {1}  # eight rows 4 apart, 64 or 128 bytes each: one bank group


def test_shared_memory_fits_two_blocks():
    smem = STAGES * (FM + FN) * FK * 4
    assert BLOCKS * (smem + 1024) <= 228 * 1024


def gemm_mirror(a, w, bias, residual=None):
    """The kernel's arithmetic for one output: an FMA chain over k in order
    (zero-filled chunks past k add nothing), then the fp32 bias, then the
    residual. Each FMA is formed in float64, then rounded to fp32."""
    m, k = a.shape
    acc = np.zeros((m, w.shape[0]), np.float32)
    for kk in range(cdiv(k, FK) * FK):
        if kk < k:
            acc = (acc.astype(np.float64)
                   + a[:, kk, None].astype(np.float64) * w[None, :, kk]).astype(np.float32)
    y = acc + bias
    return y if residual is None else residual + y


@pytest.mark.parametrize("m,k,n", [(40, 48, 96), (7, 16, 8)])
def test_gemm_mirror_matches_linear_plain(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, k ** -0.5, (n, k)).astype(np.float32)
    bias = rng.normal(0, 0.02, (n,)).astype(np.float32)
    res = rng.normal(0, 1, (m, n)).astype(np.float32)
    for r in (None, res):
        want = linear_plain(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(bias),
                            None if r is None else torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(gemm_mirror(a, w, bias, r), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- LayerNorm mirror

LN_VECS = [int(v) for v in re.findall(r"per_lane <= (\d+)\)", SRC)] + [const("kLnMaxVecs")]


def ln_vectors_a_lane(cols: int, itemsize: int) -> int:
    """NV of the instantiation ``launch_layernorm`` picks for a row."""
    need = cdiv(cols * itemsize // 16, 32)
    return next(v for v in LN_VECS if v >= need)


def butterfly(s):
    """xor-shuffle sum over the 32 lanes (axis 1), in fp32."""
    for off in (16, 8, 4, 2, 1):
        s = (s + s[:, np.arange(32) ^ off]).astype(np.float32)
    return s


def fma32(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def layernorm_mirror(x, g, b, eps, itemsize):
    """``layernorm_kernel`` row by row in fp32: lane l holds the row's
    16-byte vectors l, l + 32, ...; it sums them in order, the butterfly adds
    the lanes, and so again over (x - mu)^2; y = fma((x - mu) * inv, g, b)."""
    rows, cols = x.shape
    vec = 16 // itemsize
    nv, per_lane = cols // vec, ln_vectors_a_lane(cols, itemsize)
    # (rows, lane, vector j, element e), zeros past the row's end
    held = np.zeros((rows, 32, per_lane, vec), np.float32)
    valid = np.zeros((32, per_lane), bool)
    for j in range(per_lane):
        for lane in range(32):
            at = 32 * j + lane
            if at < nv:
                held[:, lane, j] = x[:, at * vec:(at + 1) * vec]
                valid[lane, j] = True
    s = np.zeros((rows, 32), np.float32)
    for j in range(per_lane):
        for e in range(vec):
            s = (s + held[:, :, j, e]).astype(np.float32)
    total = butterfly(s)
    assert (total == total[:, :1]).all()  # every lane the same bits
    mu = (total[:, 0] / np.float32(cols)).astype(np.float32)[:, None]
    sq = np.zeros((rows, 32), np.float32)
    for j in range(per_lane):
        for e in range(vec):
            d = (held[:, :, j, e] - mu).astype(np.float32)
            sq = np.where(valid[None, :, j], fma32(d, d, sq), sq)
    var = butterfly(sq)[:, :1]
    inv = (np.float32(1) / np.sqrt(((var / np.float32(cols)).astype(np.float32)
                                    + np.float32(eps)).astype(np.float32))).astype(np.float32)
    return fma32(((x - mu).astype(np.float32) * inv).astype(np.float32), g, b)


@pytest.mark.parametrize("cols", [32, 64, 96, 256, 768, 2048])
def test_layernorm_mirror_matches_plain_f32(cols):
    rng = np.random.default_rng(cols)
    x = (rng.normal(0.5, 2.0, (9, cols))).astype(np.float32)
    g = rng.normal(1, 0.1, cols).astype(np.float32)
    b = rng.normal(0, 0.1, cols).astype(np.float32)
    got = layernorm_mirror(x, g, b, 1e-12, 4)
    want = layernorm_plain(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cols", [32, 96, 768])
def test_layernorm_mirror_matches_plain_bf16(cols):
    """bf16 rows: eight values a vector, statistics in fp32; the one bf16
    rounding at the end may land a step apart where the fp32 values differ
    in their last bits."""
    rng = np.random.default_rng(cols + 1)
    xt = torch.from_numpy(rng.normal(0, 1, (9, cols)).astype(np.float32)).bfloat16()
    g = rng.normal(1, 0.1, cols).astype(np.float32)
    b = rng.normal(0, 0.1, cols).astype(np.float32)
    got = torch.from_numpy(layernorm_mirror(xt.float().numpy(), g, b, 1e-12, 2)).bfloat16()
    want = layernorm_plain(xt, torch.from_numpy(g), torch.from_numpy(b))
    assert torch.mean((got == want).float()) > 0.99
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("cols,itemsize", [(32, 4), (64, 4), (96, 4), (256, 4), (768, 4),
                                           (768, 2), (2048, 4), (4096, 2)])
def test_layernorm_instantiation_holds_the_row(cols, itemsize):
    """The picked NV holds every vector of the row in 32 lanes, and no
    smaller instantiation would; the wrapper's width limit is the kernel's."""
    nv = cols * itemsize // 16
    per_lane = ln_vectors_a_lane(cols, itemsize)
    assert 32 * per_lane >= nv
    assert all(32 * v < nv for v in LN_VECS if v < per_lane)
    assert _LN_MAX_BYTES == 32 * max(LN_VECS) * 16


def test_row_width_check():
    _check_row_width("layernorm", torch.empty(1, 768), 768)
    _check_row_width("layernorm", torch.empty(1, 4096, dtype=torch.bfloat16), 4096)
    for x in (torch.empty(1, 2049), torch.empty(1, 4104, dtype=torch.bfloat16),
              torch.empty(1, 30), torch.empty(1, 12, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="16 bytes"):
            _check_row_width("layernorm", x, x.shape[-1])
