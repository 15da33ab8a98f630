"""Segment-parallel consensus alignment — chunked affine banded DP.

The round-4 consensus aligned each read against its whole consensus
window with one lax.scan over the read length (ops/banded.py): at
LA=32768 that is latency-bound (each row is a tiny [B, W] op), and each
batch costs several host round trips.

This kernel restructures the work for a wide data-parallel device
(reference analogue: the
zmer-window piecewise alignment of aln_read_wtcns, wtcns.c:286-434,
which also aligns reads piecewise against consensus windows and
stitches): every read is cut into fixed SEGR-row segments (overlapping
by OVL so the host stitcher can cut at agreeing match columns), all
segments of all reads form one uniform [C, Bc] grid, and ONE dispatch
scans the chunks: per chunk an affine banded DP over SEGR rows plus an
in-jit traceback emitting 2-bit move codes.  Sequential step count per
iteration drops from sum(read lengths) to C * (SEGR + T)/UNROLL while
lane occupancy rises from ~64 to Bc=512 — the scan is throughput-bound
instead of latency-bound.

Scoring replicates kswx_refine_alignment's affine recurrence
(kswx.h:602-631, see ops/refine.py) so the separate refine pass is
subsumed: one affine DP with canonical (reference) gap placement.
Semiglobal in b: leading/trailing consensus gaps are free per segment
(the stitcher discards overlap columns anyway).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

NEG = jnp.int32(-10000)

# move codes in the packed traceback stream
MV_M, MV_I, MV_D, MV_NONE = 0, 1, 2, 3


@functools.partial(
    jax.jit,
    static_argnames=("SEGR", "LBW", "W", "T", "match", "mismatch",
                     "open_i", "open_d", "ext"),
)
def seg_align_tb(
    seg_a,       # [Bc, SEGR] uint8 read segment codes (4 = pad)
    seg_b,       # [Bc, LBW] uint8 consensus window codes (4 = pad)
    seg_alen,    # [Bc] int32 rows in this segment (<= SEGR)
    seg_blen,    # [Bc] int32 window length (<= LBW)
    seg_b16,     # [Bc, NB] int16 band base rel. to w0, sampled stride 16
    *,
    SEGR: int,
    LBW: int,
    W: int = 256,
    T: int = 3072,
    match: int = 2,
    mismatch: int = -5,
    open_i: int = -3,
    open_d: int = -3,
    ext: int = -1,
):
    """Returns (score [Bc], b_beg [Bc], b_end [Bc], mvp [Tp, Bc]).

    mvp packs 4 two-bit move codes per byte along the T axis, stream
    stored backwards from (alen, b_end); code 3 = past the start.
    b_beg/b_end are window-relative columns.  One dispatch per chunk —
    the outer chunk loop lives in the caller (a multi-chunk lax.scan
    faulted at genome scale on the smaller-memory accelerator this was
    first tuned on; not yet re-checked on the H100)."""
    Bc = seg_alen.shape[0]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    ext_ = jnp.int32(ext)
    Tp = T // 4

    def chunk(a, b, alen, blen, b16):
        ai = a.astype(jnp.int32)
        bi = b.astype(jnp.int32)
        # upsample the stride-16 band base to per-row, monotone + clipped
        NB = b16.shape[1]
        k = jnp.arange(SEGR + 1, dtype=jnp.int32)
        ki = k // 16
        kf = k % 16
        b32 = b16.astype(jnp.int32)
        lo = jnp.take_along_axis(b32, jnp.broadcast_to(ki[None], (Bc, SEGR + 1)),
                                 axis=1)
        hi = jnp.take_along_axis(
            b32, jnp.broadcast_to(jnp.minimum(ki + 1, NB - 1)[None],
                                  (Bc, SEGR + 1)), axis=1)
        base = lo + (hi - lo) * kf[None, :] // 16
        base = jnp.clip(base, 0, jnp.maximum(blen[:, None] - 1, 0))
        base = jax.lax.associative_scan(jnp.maximum, base, axis=1)

        def fscan(m):
            def comb(x, y):
                vx, nx = x
                vy, ny = y
                return jnp.maximum(vx + ext_ * ny, vy), nx + ny

            v = m + jnp.int32(open_d) + ext_
            ones = jnp.ones_like(m)
            s, _ = jax.lax.associative_scan(comb, (v, ones), axis=1)
            return jnp.concatenate([jnp.full((Bc, 1), NEG), s[:, :-1]], axis=1)

        # row 0: semiglobal in b — H = 0 across the whole band
        j0cols = base[:, 0:1] + lanes
        h0 = jnp.where((j0cols >= 0) & (j0cols <= blen[:, None]),
                       jnp.int32(0), NEG)
        e0 = jnp.full((Bc, W), NEG)

        def row_update(carry, i):
            hprev, eprev = carry
            bs = jax.lax.dynamic_index_in_dim(base, i, axis=1, keepdims=False)
            bp = jax.lax.dynamic_index_in_dim(base, i - 1, axis=1,
                                              keepdims=False)
            shift = (bs - bp)[:, None]
            j = bs[:, None] + lanes
            idx_up = lanes + shift
            idx_dg = lanes + shift - 1

            def shifted(x, idx):
                return jnp.where(
                    (idx >= 0) & (idx < W),
                    jnp.take_along_axis(x, jnp.clip(idx, 0, W - 1), axis=1),
                    NEG)

            hdg = shifted(hprev, idx_dg)
            eup = shifted(eprev, idx_up)
            ac = jnp.take_along_axis(ai, jnp.clip(i - 1, 0, SEGR - 1)
                                     * jnp.ones((Bc, 1), jnp.int32), axis=1)
            bc = jnp.take_along_axis(bi, jnp.clip(j - 1, 0, LBW - 1), axis=1)
            sub = jnp.where((ac == bc) & (ac < 4) & (bc < 4), match, mismatch)
            okj = (j >= 1) & (j <= blen[:, None])
            m = jnp.where(okj, hdg + sub, NEG)
            # kswx.h:610-631 exactly (see ops/refine.py): E/F lanes open
            # from the DIAGONAL candidate m, F strictly-greater tie rule,
            # extension flags stored in this row's direction byte
            e = eup
            d = jnp.where(m >= e, jnp.uint8(0), jnp.uint8(1))
            h = jnp.maximum(m, e)
            f = fscan(jnp.where(okj, m, NEG))
            use_f = f > h
            d = jnp.where(use_f, jnp.uint8(2), d)
            h = jnp.maximum(h, f)
            e_ext = e + ext_
            e_open = m + jnp.int32(open_i) + ext_
            d = d | jnp.where(e_ext > e_open, jnp.uint8(1 << 2), jnp.uint8(0))
            e_next = jnp.maximum(e_ext, e_open)
            f1 = jnp.concatenate(
                [jnp.full((Bc, 1), NEG),
                 (jnp.where(okj, m, NEG) + jnp.int32(open_d) + ext_)[:, :-1]],
                axis=1)
            d = d | jnp.where(f > f1, jnp.uint8(2 << 4), jnp.uint8(0))
            oki = i <= alen[:, None]
            h = jnp.where(okj & oki, h, NEG)
            e_next = jnp.where(oki, e_next, NEG)
            return (h, e_next), (h, d)

        UNROLL = 4 if SEGR % 4 == 0 else 1

        def rstep(carry, i0):
            c, hold = carry
            ds_u = []
            for u in range(UNROLL):
                i = i0 * UNROLL + u + 1
                c, (h_u, d_u) = row_update(c, i)
                hold = jnp.where(i == alen[:, None], h_u, hold)
                ds_u.append(d_u)
            return (c, hold), jnp.stack(ds_u)

        iters = jnp.arange(0, SEGR // UNROLL, dtype=jnp.int32)
        ((hl, _el), hold), ds = jax.lax.scan(rstep, ((h0, e0), h0), iters)
        ds = ds.reshape(SEGR, Bc, W)
        dirs = jnp.concatenate([jnp.zeros((1, Bc, W), jnp.uint8), ds], axis=0)

        bidx = jnp.arange(Bc)
        last_base = base[bidx, alen]
        cols = last_base[:, None] + lanes
        okc = (cols >= 0) & (cols <= blen[:, None])
        masked = jnp.where(okc, hold, NEG)
        lane_end = jnp.argmax(masked, axis=1).astype(jnp.int32)
        score = jnp.take_along_axis(masked, lane_end[:, None], axis=1)[:, 0]
        end_col = last_base + lane_end

        # ---- in-jit traceback (kswx state machine, semiglobal stop) ----
        i0 = alen
        jj0 = end_col
        done0 = i0 <= 0

        def tstep(carry, _):
            i, j, state, done = carry
            mv4 = jnp.zeros(Bc, jnp.uint8)
            for u in range(4):
                ic = jnp.clip(i, 0, SEGR)
                lane = j - base[bidx, ic]
                inband = (lane >= 0) & (lane < W)
                z = jnp.where(
                    inband & ~done,
                    dirs[ic, bidx, jnp.clip(lane, 0, W - 1)].astype(jnp.int32),
                    0)
                mv = (z >> (2 * state)) & 3
                mv = jnp.where(j <= 0, MV_I, mv)
                mv = jnp.where(i <= 0, MV_NONE, mv)  # semiglobal: stop at row 0
                mv = jnp.where(done, MV_NONE, mv)
                i = i - ((mv == MV_M) | (mv == MV_I)).astype(jnp.int32)
                j = j - ((mv == MV_M) | (mv == MV_D)).astype(jnp.int32)
                state = jnp.where(mv == MV_NONE, state, mv)
                done = done | (i <= 0)
                mv4 = mv4 | (mv.astype(jnp.uint8) << (2 * u))
            return (i, j, state, done), mv4

        (i_f, j_f, _s, _d), mvp = jax.lax.scan(
            tstep, (i0, jj0, jnp.zeros_like(i0), done0), None, length=Tp)
        return score, jnp.maximum(j_f, 0), end_col, mvp

    return chunk(seg_a, seg_b, seg_alen, seg_blen, seg_b16)


def unpack_moves(mvp: np.ndarray) -> np.ndarray:
    """[C, Tp, Bc] packed bytes -> [C, 4*Tp, Bc] 2-bit move codes."""
    C, Tp, Bc = mvp.shape
    out = np.empty((C, Tp, 4, Bc), np.uint8)
    for u in range(4):
        out[:, :, u] = (mvp >> (2 * u)) & 3
    return out.reshape(C, 4 * Tp, Bc)


def moves_to_cigar(mv_col: np.ndarray):
    """One segment's backward move stream -> forward (ops, counts) lists."""
    mv = mv_col[mv_col != MV_NONE][::-1]
    if mv.size == 0:
        return [], []
    cut = np.nonzero(np.diff(mv))[0]
    starts = np.concatenate([[0], cut + 1])
    ends = np.concatenate([cut + 1, [mv.size]])
    ops = ["MID"[int(mv[s])] for s in starts]
    counts = [int(e - s) for s, e in zip(starts, ends)]
    return ops, counts
