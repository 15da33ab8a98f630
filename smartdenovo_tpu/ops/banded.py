"""Anchor-guided banded alignment — batched shifting-band DP on device.

Batched device equivalent of the reference's scalar shifting-band DP
(kswx.h:101-232 kswx_extend_align_shift_core) and CIGAR-guided variable
band refine (kswx.h:483-659): instead of adapting the band to the best
cell per row (serial), the band center per row is *precomputed* from
chained z-mer anchors (piecewise-linear, like the prior-CIGAR band of
kswx_refine_alignment), which makes every row update a pure [B, W]
vector op.  The within-row (gap-in-b) dependency is a max-plus prefix
scan solved with an associative scan in log2(W) steps.

Row axis = sequence `a` (the read); columns = sequence `b` (consensus
window).  Linear gap model with the reference's default scores.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

NEG_INF = jnp.int32(-(1 << 28))
DIAG, UP, LEFT, STOP = 1, 2, 3, 0


@functools.partial(
    jax.jit,
    static_argnames=("LA", "W", "match", "mismatch", "gap", "gap_a", "gap_b",
                     "semiglobal_b", "return_rowmax"),
)
def banded_align(
    a: jnp.ndarray,       # [B, LA] uint8
    b: jnp.ndarray,       # [B, LB] uint8
    alen: jnp.ndarray,    # [B] int32
    blen: jnp.ndarray,    # [B] int32
    base: jnp.ndarray,    # [B, LA+1] int32: leftmost band column per row
    *,
    LA: int,
    W: int = 256,
    match: int = 2,
    mismatch: int = -5,
    gap: int = -3,
    gap_a: int | None = None,   # cost of consuming a (insertion in a / UP)
    gap_b: int | None = None,   # cost of consuming b (deletion / LEFT)
    semiglobal_b: bool = False,
    return_rowmax: bool = False,  # also return per-row best (score, col)
):
    """Returns (score [B], end_col [B], dirs [B, LA+1, W] uint8).

    semiglobal_b=True makes end gaps in `b` free (read-global, window-
    local): row 0 costs nothing and the score is the best cell of the
    last row — the mode used for read-vs-backbone consensus alignment.
    """
    if gap_a is None:
        gap_a = gap
    if gap_b is None:
        gap_b = gap
    B = a.shape[0]
    LB = b.shape[1]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    ai = a.astype(jnp.int32)
    bi = b.astype(jnp.int32)

    def leftscan(m):
        # S[c] = max_{k<=c} m[k] + gap_b*(c-k), via associative max-plus scan
        def comb(x, y):
            vx, nx = x
            vy, ny = y
            return jnp.maximum(vx + gap_b * ny, vy), nx + ny

        ones = jnp.ones_like(m)
        s, _ = jax.lax.associative_scan(comb, (m, ones), axis=1)
        return s

    def row0():
        j = base[:, 0:1] + lanes
        h = jnp.zeros_like(j) if semiglobal_b else gap_b * j
        ok = (j >= 0) & (j <= blen[:, None])
        h = jnp.where(ok, h, NEG_INF)
        if semiglobal_b:
            d = jnp.where(ok, jnp.uint8(STOP), jnp.uint8(STOP))
        else:
            d = jnp.where(j == 0, jnp.uint8(STOP), jnp.uint8(LEFT))
            d = jnp.where(ok, d, jnp.uint8(STOP))
        return h, d

    h0, d0 = row0()

    def row_update(hprev, i):
        # i is a scalar row index (same for the whole batch)
        bs = jax.lax.dynamic_index_in_dim(base, i, axis=1, keepdims=False)      # [B]
        bp = jax.lax.dynamic_index_in_dim(base, i - 1, axis=1, keepdims=False)  # [B]
        shift = (bs - bp)[:, None]
        j = bs[:, None] + lanes   # columns of this row
        idx_up = lanes + shift
        idx_dg = lanes + shift - 1
        up = jnp.where(
            (idx_up >= 0) & (idx_up < W),
            jnp.take_along_axis(hprev, jnp.clip(idx_up, 0, W - 1), axis=1),
            NEG_INF,
        )
        dg = jnp.where(
            (idx_dg >= 0) & (idx_dg < W),
            jnp.take_along_axis(hprev, jnp.clip(idx_dg, 0, W - 1), axis=1),
            NEG_INF,
        )
        ac = jax.lax.dynamic_index_in_dim(ai, jnp.clip(i - 1, 0, LA - 1), axis=1,
                                          keepdims=True)  # [B, 1]
        bc = jnp.take_along_axis(bi, jnp.clip(j - 1, 0, LB - 1), axis=1)
        sub = jnp.where((ac == bc) & (ac < 4), match, mismatch)
        m = jnp.maximum(dg + sub, up + gap_a)
        dirm = jnp.where(dg + sub >= up + gap_a, jnp.uint8(DIAG), jnp.uint8(UP))
        # first column boundary
        at0 = j == 0
        m = jnp.where(at0, gap_a * i, m)
        dirm = jnp.where(at0, jnp.uint8(UP), dirm)
        okj = (j >= 0) & (j <= blen[:, None])
        oki = i <= alen[:, None]
        m = jnp.where(okj & oki, m, NEG_INF)
        s = leftscan(m)
        d = jnp.where(s > m, jnp.uint8(LEFT), dirm)
        d = jnp.where(okj & oki & (s > NEG_INF // 2), d, jnp.uint8(STOP))
        s = jnp.where(okj & oki, s, NEG_INF)
        return s, (s, d)

    # UNROLL rows per scan step: the per-row tensors are tiny ([B, W]),
    # so wall-clock is bound by the sequential step count, not FLOPs.
    # Only the DIRECTION plane is stacked; each read's final H row is
    # captured into the carry at i == alen (stacking H too held an extra
    # [LA, B, W] int32 — the difference between fitting B=128 in HBM and
    # a 2.25 GB OOM at consensus scale).
    UNROLL = 4 if LA % 4 == 0 else (2 if LA % 2 == 0 else 1)

    def step(carry, i0):
        h, hold = carry
        dd = []
        ss = []
        for u in range(UNROLL):
            i = i0 * UNROLL + u + 1
            h, (s_u, d_u) = row_update(h, i)
            hold = jnp.where(i == alen[:, None], s_u, hold)
            dd.append(d_u)
            ss.append(s_u)
        ys = (jnp.stack(dd), jnp.stack(ss)) if return_rowmax else jnp.stack(dd)
        return (h, hold), ys

    iters = jnp.arange(0, LA // UNROLL, dtype=jnp.int32)
    (hlast, hold), ys = jax.lax.scan(step, (h0, h0), iters)
    if return_rowmax:
        ds, hs = ys
        hs = hs.reshape(LA, B, W)
    else:
        ds = ys
    ds = ds.reshape(LA, B, W)
    dirs = jnp.concatenate([d0[None], ds], axis=0)  # [LA+1, B, W]
    bidx = jnp.arange(B)
    last_base = base[bidx, alen]
    if semiglobal_b:
        last_row = hold                   # H at row alen per read
        cols = last_base[:, None] + lanes
        okc = (cols >= 0) & (cols <= blen[:, None])
        masked = jnp.where(okc, last_row, NEG_INF)
        lane_end = jnp.argmax(masked, axis=1).astype(jnp.int32)
        score = jnp.take_along_axis(masked, lane_end[:, None], axis=1)[:, 0]
        end_col = last_base + lane_end
    else:
        lane_end = blen - last_base
        score = jnp.take_along_axis(
            hold, jnp.clip(lane_end, 0, W - 1)[:, None], axis=1)[:, 0]
        score = jnp.where((lane_end >= 0) & (lane_end < W), score, NEG_INF)
        end_col = blen
    dirs_t = jnp.transpose(dirs, (1, 0, 2))
    if return_rowmax:
        # per-row best in-band cell (for extension alignments that may
        # stop early with an end-clip bonus, reference kswx T logic)
        hs_all = jnp.concatenate([h0[None], hs], axis=0)
        cols = base[:, :, None] + lanes[None]            # [B, LA+1, W]
        hrows = jnp.transpose(hs_all, (1, 0, 2))         # [B, LA+1, W]
        okc = (cols >= 0) & (cols <= blen[:, None, None])
        masked = jnp.where(okc, hrows, NEG_INF)
        rlane = jnp.argmax(masked, axis=2).astype(jnp.int32)
        rmax = jnp.take_along_axis(masked, rlane[:, :, None], axis=2)[:, :, 0]
        rcol = jnp.take_along_axis(cols, rlane[:, :, None], axis=2)[:, :, 0]
        return score, end_col, dirs_t, rmax, rcol
    return score, end_col, dirs_t


def make_band_centers(anchors_list, alens, blens, LA: int, W: int) -> np.ndarray:
    """Build per-row leftmost band columns from (a_pos, b_pos) anchors.

    anchors_list: per pair, array [(a_pos, b_pos), ...] (may be empty).
    Endpoints (0,0) and (alen, blen) are always included; centers are the
    piecewise-linear interpolation, clamped so the band stays in range.
    """
    B = len(anchors_list)
    base = np.zeros((B, LA + 1), np.int32)
    rows = np.arange(LA + 1)
    for i, anc in enumerate(anchors_list):
        al, bl = int(alens[i]), int(blens[i])
        pts = sorted((int(x), int(y)) for x, y in anc if 0 <= x <= al and 0 <= y <= bl)
        xs, ys = [], []
        lastx = -1
        for x, y in pts:
            if x <= lastx:
                continue
            xs.append(x)
            ys.append(y)
            lastx = x
        if not xs:
            xs, ys = [0, al], [0, bl]
        else:
            # extrapolate the chain's diagonal to the sequence ends instead of
            # pinning (0,0)/(al,bl): the window may extend past the read span
            if xs[0] > 0:
                xs.insert(0, 0)
                ys.insert(0, ys[0] - xs[1])
            if xs[-1] < al:
                ys.append(ys[-1] + (al - xs[-1]))
                xs.append(al)
        center = np.interp(np.minimum(rows, al), xs, ys)
        base[i] = np.clip(center.astype(np.int64) - W // 2, -(W - 1), max(0, bl))
        # monotone non-decreasing so shifts are >= 0
        np.maximum.accumulate(base[i], out=base[i])
    return base


def traceback_banded(dirs, base: np.ndarray, alen, end_col):
    """Traceback for banded_align (device scan + host run-length encode).

    dirs may be a DEVICE array (preferred — only the [steps, B] move
    stream is fetched, not the whole direction plane) or numpy.
    Returns (cigars, b_beg): per pair (ops, counts) run-length lists with
    ops M/I/D (I consumes a/row, D consumes b/col), and the column in b
    where the alignment starts (meaningful for semiglobal_b)."""
    from .traceback import rle_moves, tb_banded_device

    B, LR, W = dirs.shape
    T = 2 * LR + W
    mvs, j_final = tb_banded_device(
        jnp.asarray(dirs), jnp.asarray(base),
        jnp.asarray(np.asarray(alen, np.int32)),
        jnp.asarray(np.asarray(end_col, np.int32)), T=T)
    mvs = np.asarray(mvs)
    j = np.asarray(j_final, np.int64)
    code2op = {DIAG: "M", UP: "I", LEFT: "D"}
    out = [rle_moves(mvs[:, b], code2op, 0) for b in range(B)]
    return out, np.maximum(j, 0)
