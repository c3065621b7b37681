"""The shared-memory and packed layouts of the bf16 tensor-core kernels
(``csrc/conv_rows_bf16.cuh`` and ``pack_weights_bf16_kernel`` in
``csrc/fused_embedding.cu``), mirrored in plain torch: every operand is read
the way the kernels address it (the packed weight runs a stage copies, the
``wgmma`` shared-memory descriptors with their core matrices, the slab with a
tap's row offset as a shift of the descriptor's start, the ``ldmatrix``
lanes and registers) and the products are held in float64 against
``conv2d`` (forward and data gradient) and against autograd's weight
gradient, at S = 9 and 13 with rows that do not fill the last tile. Change
these together with the CUDA source."""

import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as tfe

KC_STAGE_ROWS = {9: 128, 1: 64}  # wgrad_rows_per_stage
WG_COB = 64  # kWgCOB


def pack_conv_weight_bf16(w: torch.Tensor, taps: int, flip: bool = False) -> torch.Tensor:
    """``pack_weights_bf16_kernel``: the GEMM operand ``B[tap][k][n]`` of a
    conv weight stored ``(taps·cin, cout)`` (with ``flip``, the data
    gradient's: taps reversed, each transposed) as the flat array
    ``[tap][K/16][N/8][2][8 n][8 k]``: per block of 16 k and 8 n two core
    matrices (k 0-7, then k 8-15) of 8 rows n, each row the 8 k of that n."""
    cout = w.shape[1]
    b = w.reshape(taps, -1, cout)
    if flip:
        b = b.flip(0).transpose(1, 2)
    _, k, n = b.shape
    v = b.reshape(taps, k // 16, 2, 8, n // 8, 8)  # tap, kb, half, kq, nb, r
    return v.permute(0, 1, 4, 2, 5, 3).reshape(-1)


def desc_index(start: int, k: torch.Tensor, n: torch.Tensor, lbo: int, sbo: int, mn_major: bool):
    """Element index (2-byte elements) of ``(k, n)`` of a ``wgmma`` operand
    read through a no-swizzle descriptor at element ``start``: core
    matrices of 8 rows of 16 bytes, ``lbo`` bytes to the next along k,
    ``sbo`` bytes to the next along n; a K-major core matrix's rows are n
    (8 k each), an MN-major one's are k (8 n each)."""
    inner = (k % 8) * 16 + (n % 8) * 2 if mn_major else (n % 8) * 16 + (k % 8) * 2
    return start + ((k // 8) * lbo + (n // 8) * sbo + inner) // 2


def _bits(s: int, r: int, taps: int) -> torch.Tensor:
    """Each row's validity word as the kernels take it: the table's for a
    3x3 conv, 1 (its one tap) for a 1x1."""
    if taps == 1:
        return torch.ones(r, dtype=torch.int32)
    return tfe.tap_validity(s)[torch.arange(r) % (s * s)]


def conv_bf16_mirror(x_rows, packed, s, taps, cin, cout, bm, bn):
    """``conv_bf16_kernel`` on ``(R, cin)`` rows: per row tile of ``bm``,
    column tile of ``bn``, stage (chunk of KC channels, tap) and step of 16
    channels, the A fragment from the slab at the tap's row offset, zeroed
    where the tap leaves the image, times B read from the stage's weight
    tile through its descriptor (``lbo`` 128 bytes, ``sbo`` 256)."""
    r = x_rows.shape[0]
    kc = 64 if cin % 64 == 0 else 32
    halo = s + 1 if taps == 9 else 0
    bits = _bits(s, r, taps)
    out = torch.zeros(r, cout, dtype=x_rows.dtype)
    k16 = torch.arange(16)[:, None].expand(16, bn)
    nn = torch.arange(bn)[None, :].expand(16, bn)
    for row0 in range(0, r, bm):
        rows = torch.arange(row0, row0 + bm)
        first = row0 - halo
        slab_idx = torch.arange(first, first + bm + 2 * halo)
        slab = torch.zeros(len(slab_idx), cin, dtype=x_rows.dtype)
        inside = (slab_idx >= 0) & (slab_idx < r)
        slab[inside] = x_rows[slab_idx[inside]]
        vm = torch.where(rows < r, bits[rows.clamp(max=r - 1)], torch.zeros_like(rows, dtype=torch.int32))
        for col0 in range(0, cout, bn):
            acc = torch.zeros(bm, bn, dtype=x_rows.dtype)
            for chunk in range(cin // kc):
                for tap in range(taps):
                    # the stage's weight tile: kc / 16 runs of bn * 16 values
                    runs = []
                    for kk in range(kc // 16):
                        at = ((tap * (cin // 16) + chunk * (kc // 16) + kk) * (cout // 8) + col0 // 8) * 128
                        runs.append(packed[at : at + bn * 16])
                    tile = torch.cat(runs)
                    off = (tap // 3 - 1) * s + (tap % 3 - 1) if taps == 9 else 0
                    keep = ((vm >> tap) & 1).to(x_rows.dtype)[:, None]
                    a_rows = slab[halo + off : halo + off + bm] * keep
                    for kk in range(kc // 16):
                        b = tile[desc_index(kk * bn * 16, k16, nn, 128, 256, mn_major=False)]
                        a = a_rows[:, chunk * kc + kk * 16 : chunk * kc + kk * 16 + 16]
                        acc = acc + a @ b
            n_in = min(bm, r - row0)
            out[row0 : row0 + n_in, col0 : col0 + bn] = acc[:n_in]
    return out


def wgrad_bf16_mirror(x_rows, g_rows, s, taps, rows_per_chunk):
    """``wgrad_bf16_kernel``: per row chunk, stage of RB rows and step of 16
    rows, A = g^T (co x rows) zeroed per tap where the tap leaves the image,
    times B read from the slab laid out ``[cin/8][slab row][8]`` through an
    MN-major descriptor whose start is shifted by the tap's row offset
    (``lbo`` 128 bytes, ``sbo`` a slab plane); the chunks summed after.
    Returns ``(taps, cin, cout)``."""
    r, cin = x_rows.shape
    cout = g_rows.shape[1]
    cib = 64 if cin % 64 == 0 else 32
    rb = KC_STAGE_ROWS[taps]
    halo = s + 1 if taps == 9 else 0
    bits = _bits(s, r, taps)
    slab_rows = rb + 2 * halo
    total = torch.zeros(taps, cin, cout, dtype=x_rows.dtype)
    kk = torch.arange(16)[:, None].expand(16, cib)
    nn = torch.arange(cib)[None, :].expand(16, cib)
    for r_begin in range(0, r, rows_per_chunk):
        r_end = min(r, r_begin + rows_per_chunk)
        part = torch.zeros(taps, cin, cout, dtype=x_rows.dtype)
        for ci0 in range(0, cin, cib):
            for co0 in range(0, cout, WG_COB):
                for rb0 in range(r_begin, r_end, rb):
                    src = torch.arange(rb0 - halo, rb0 - halo + slab_rows)
                    ok = (src >= 0) & (src < r)
                    rows_x = torch.zeros(slab_rows, cib, dtype=x_rows.dtype)
                    rows_x[ok] = x_rows[src[ok], ci0 : ci0 + cib]
                    # [cib / 8][slab row][8]
                    plane = rows_x.reshape(slab_rows, cib // 8, 8).permute(1, 0, 2).reshape(-1)
                    grow = torch.arange(rb0, rb0 + rb)
                    live = grow < r_end
                    g_s = torch.zeros(rb, WG_COB, dtype=x_rows.dtype)
                    g_s[live] = g_rows[grow[live], co0 : co0 + WG_COB]
                    m_s = torch.where(live, bits[grow.clamp(max=r - 1)], torch.zeros_like(grow, dtype=torch.int32))
                    for rl in range(0, rb, 16):
                        for t in range(taps):
                            off = (t // 3 - 1) * s + (t % 3 - 1) if taps == 9 else 0
                            keep = ((m_s[rl : rl + 16] >> t) & 1).to(x_rows.dtype)
                            a = (g_s[rl : rl + 16] * keep[:, None]).T  # (co, 16 rows)
                            start = (halo + rl + off) * 8
                            b = plane[desc_index(start, kk, nn, 128, slab_rows * 16, mn_major=True)]
                            part[t, ci0 : ci0 + cib, co0 : co0 + WG_COB] += (a @ b).T
        total += part
    return total


def _case(n, s, cin, cout, taps, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(n, cin, s, s)), dtype=torch.float64)
    k = 3 if taps == 9 else 1
    w = torch.tensor(rng.normal(size=(k, k, cin, cout)) / np.sqrt(taps * cin), dtype=torch.float64)
    return x, w


def _rows(x):
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


@pytest.mark.parametrize("s", [9, 13])
@pytest.mark.parametrize("taps,cin,cout,bm,bn", [(9, 64, 128, 128, 128), (9, 32, 64, 64, 32), (1, 64, 128, 64, 64)])
def test_packed_weights_through_descriptors_equal_conv2d_forward_and_data_gradient(s, taps, cin, cout, bm, bn):
    """The conv read as the bf16 kernel reads it (packed weight runs, the
    K-major descriptor, slab fragments at tap offsets with the validity
    table, tiles that overhang the rows) equals ``conv2d`` with SAME
    padding, and with the flipped packing its gradient for the input; in
    float64, to 1e-12 of the largest value."""
    n = 3
    x, w = _case(n, s, cin, cout, taps, seed=s + taps + cin)
    want = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), padding=taps // 9)
    packed = pack_conv_weight_bf16(w.reshape(taps * cin, cout), taps)
    assert packed.numel() == taps * cin * cout
    got = conv_bf16_mirror(_rows(x), packed, s, taps, cin, cout, bm, bn)
    assert float((got - _rows(want)).abs().max()) <= 1e-12 * float(want.abs().max())

    g = torch.tensor(np.random.default_rng(1).normal(size=want.shape), dtype=torch.float64)
    xg = x.clone().requires_grad_()
    torch.nn.functional.conv2d(xg, w.permute(3, 2, 0, 1), padding=taps // 9).backward(g)
    flipped = pack_conv_weight_bf16(w.reshape(taps * cin, cout), taps, flip=True)
    got = conv_bf16_mirror(_rows(g), flipped, s, taps, cout, cin, bm, min(bn, cin))
    assert float((got - _rows(xg.grad)).abs().max()) <= 1e-12 * float(xg.grad.abs().max())


@pytest.mark.parametrize("s", [9, 13])
@pytest.mark.parametrize("taps,cin,cout,rows_per_chunk", [(9, 64, 128, 256), (9, 32, 64, 128), (1, 64, 128, 128)])
def test_transposed_slab_and_masked_gradient_equal_autograd_weight_gradient(s, taps, cin, cout, rows_per_chunk):
    """The weight gradient read as the bf16 kernel reads it (the slab in
    channel-group planes read MN-major, the tap a shift of the descriptor's
    start, g^T zeroed per tap by the validity bits, row chunks whose last
    stage overhangs) equals autograd's weight gradient of ``conv2d``; in
    float64, to 1e-12 of the largest value."""
    n = 3
    x, w = _case(n, s, cin, cout, taps, seed=2 * s + taps + cin)
    g = torch.tensor(np.random.default_rng(s).normal(size=(n, cout, s, s)), dtype=torch.float64)
    wg = w.clone().requires_grad_()
    torch.nn.functional.conv2d(x, wg.permute(3, 2, 0, 1), padding=taps // 9).backward(g)
    want = wg.grad.reshape(taps, cin, cout)
    got = wgrad_bf16_mirror(_rows(x), _rows(g), s, taps, rows_per_chunk)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def _ldmatrix(addr_row, addr_col, trans: bool):
    """The (row, column) of stored element each lane's register i receives
    from ``ldmatrix.x4`` (``.trans`` with ``trans``), given each lane's row
    address ``(addr_row[l], addr_col[l])``: ``[lane][i][half] -> (row, col)``."""
    out = {}
    for lane in range(32):
        for i in range(4):
            for half in range(2):
                if trans:
                    src = 8 * i + 2 * (lane % 4) + half
                    out[lane, i, half] = (addr_row[src], addr_col[src] + lane // 4)
                else:
                    src = 8 * i + lane // 4
                    out[lane, i, half] = (addr_row[src], addr_col[src] + 2 * (lane % 4) + half)
    return out


def test_ldmatrix_lanes_give_the_wgmma_a_fragments():
    """The lanes' ``ldmatrix`` addresses of both kernels put in each register
    what ``wgmma``'s A fragment holds there (a0 = A[gid][2tig, +1], a1 =
    A[gid+8][..], a2 = A[gid][2tig+8, +9], a3 = A[gid+8][2tig+8, +9] of the
    warp's 16 rows): for the conv A is the slab (rows, channels), read
    straight; for the weight gradient A = g^T (output channels, rows), read
    transposed from the g rows."""
    lanes = range(32)
    # conv_bf16_kernel: a_lane (rows relative to the warp's first, channels)
    conv = _ldmatrix([(l & 7) + ((l >> 3) & 1) * 8 for l in lanes], [(l >> 4) * 8 for l in lanes], trans=False)
    # wgrad_bf16_kernel: g_lane (g rows, output channels relative to 16 wq)
    wgrad = _ldmatrix([(l & 7) + (l >> 4) * 8 for l in lanes], [((l >> 3) & 1) * 8 for l in lanes], trans=True)
    for lane in lanes:
        gid, tig = lane // 4, lane % 4
        for i in range(4):
            m = gid + 8 * (i % 2)
            for half in range(2):
                k = 2 * tig + 8 * (i // 2) + half
                assert conv[lane, i, half] == (m, k)
                assert wgrad[lane, i, half] == (k, m)  # g[row k][channel m] = A[m][k]


@pytest.mark.parametrize("taps,cin,cout", [(9, 32, 64), (1, 64, 128), (9, 128, 128)])
def test_bf16_packed_weight_layout_round_trips(taps, cin, cout):
    """The packed layout holds every weight once, the entry at
    ``[tap, kb, nb, half, r, q]`` is ``B[16 kb + 8 half + q][8 nb + r]``, and
    the flipped packing is the forward one of the taps reversed and each
    transposed."""
    rng = np.random.default_rng(taps + cin + cout)
    w = torch.tensor(rng.normal(size=(taps * cin, cout)), dtype=torch.float64)
    b = w.reshape(taps, cin, cout)
    packed = pack_conv_weight_bf16(w, taps).reshape(taps, cin // 16, cout // 8, 2, 8, 8)
    tap, kb, nb, half, r, q = taps - 1, 1, 2, 1, 5, 3
    assert packed[tap, kb, nb, half, r, q] == b[tap, 16 * kb + 8 * half + q, 8 * nb + r]
    flipped = pack_conv_weight_bf16(w, taps, flip=True).reshape(taps, cout // 16, cin // 8, 2, 8, 8)
    bt = b.flip(0).transpose(1, 2)
    assert flipped[tap, kb, 1, half, r, q] == bt[tap, 16 * kb + 8 * half + q, 8 + r]
    assert torch.equal(torch.sort(pack_conv_weight_bf16(w, taps)).values, torch.sort(w.reshape(-1)).values)
