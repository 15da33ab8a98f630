"""CIGAR-guided refine alignment — batched affine banded DP on device.

Batched device equivalent of `kswx_refine_alignment` (reference
kswx.h:483-659): re-run a *global* affine-gap DP inside a band around a
prior alignment path, with full traceback, producing a polished CIGAR
and exact mat/mis/ins/del stats.  This is the kernel behind wtzmo's `-n`
overlap refine and the wtcns/consensus polish (wtcns.c:372-381).

Differences from the reference, by design:
  - the reference widens the band per-row around indel runs
    (kswx.h:541-559); here the band is a fixed W tier around the prior
    path — a superset of the reference band whenever W/2 >= base W +
    the largest indel run, which the caller guarantees by picking the
    tier from the prior CIGAR's largest indel;
  - rows are batched [B, W] vector ops; the in-row (deletion) dependency
    is an associative max-plus scan, as in ops/banded.py.

Cell recurrences replicate kswx.h:602-631 exactly, including the ksw
convention that gap lanes open from the *diagonal candidate* m rather
than the row maximum h:

    m      = H[i-1][j-1] + sub(a_i, b_j)
    h      = max(m, E[j], F)        (ties: m wins over E; F only if >)
    E[j]   = max(E[j] + ext, m + open_i + ext)
    F      = max(F    + ext, m + open_d + ext)

Direction byte (2 bits per state, as kswx.h): bits 0-1 = argmax of h
(0 diag, 1 ins/E, 2 del/F); bits 2-3 = 1 if E extended; bits 4-5 = 2 if
F extended.  Traceback is the reference's state machine: in state d the
next move is (z >> (2*d)) & 3.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

NEG = jnp.int32(-10000)


@functools.partial(
    jax.jit,
    static_argnames=("LA", "W", "match", "mismatch", "open_i", "open_d",
                     "ext"),
)
def refine_banded_affine(
    a: jnp.ndarray,       # [B, LA] uint8 (query rows)
    b: jnp.ndarray,       # [B, LB] uint8 (target cols)
    alen: jnp.ndarray,    # [B] int32
    blen: jnp.ndarray,    # [B] int32
    base: jnp.ndarray,    # [B, LA+1] int32 leftmost band column per row
    *,
    LA: int,
    W: int = 128,
    match: int = 2,
    mismatch: int = -5,
    open_i: int = -3,     # reference I (insertion open, consumes a)
    open_d: int = -3,     # reference D (deletion open, consumes b)
    ext: int = -1,        # reference E
):
    """Returns (score [B], dirs [B, LA+1, W] uint8).

    Global alignment (0,0)->(alen, blen); score read at the (alen, blen)
    cell.  The caller tracebacks with `traceback_refine`.
    """
    B = a.shape[0]
    LB = b.shape[1]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    ai = a.astype(jnp.int32)
    bi = b.astype(jnp.int32)
    ext_ = jnp.int32(ext)

    def fscan(m):
        # F[c] = max_{k<c} m[k] + open_d + ext*(c-k); excludes k == c
        def comb(x, y):
            vx, nx = x
            vy, ny = y
            return jnp.maximum(vx + ext_ * ny, vy), nx + ny

        v = m + jnp.int32(open_d) + ext_
        ones = jnp.ones_like(m)
        s, _ = jax.lax.associative_scan(comb, (v, ones), axis=1)
        # shift right by one: F at c sees only k < c
        return jnp.concatenate([jnp.full((B, 1), NEG), s[:, :-1]], axis=1)

    # row 0: H[0][j] = 0 at j==0 else -10000 (kswx.h:603-604)
    def row0():
        j = base[:, 0:1] + lanes
        h = jnp.where(j == 0, jnp.int32(0), NEG)
        ok = (j >= 0) & (j <= blen[:, None])
        return jnp.where(ok, h, NEG)

    h0 = row0()
    e0 = jnp.full((B, W), NEG)

    def row_update(carry, i):
        hprev, eprev = carry
        bs = jax.lax.dynamic_index_in_dim(base, i, axis=1, keepdims=False)
        bp = jax.lax.dynamic_index_in_dim(base, i - 1, axis=1, keepdims=False)
        shift = (bs - bp)[:, None]
        j = bs[:, None] + lanes
        idx_up = lanes + shift       # same column, previous row
        idx_dg = lanes + shift - 1   # previous column, previous row

        def shifted(x, idx):
            return jnp.where(
                (idx >= 0) & (idx < W),
                jnp.take_along_axis(x, jnp.clip(idx, 0, W - 1), axis=1),
                NEG,
            )

        hup = shifted(hprev, idx_up)
        hdg = shifted(hprev, idx_dg)
        eup = shifted(eprev, idx_up)
        ac = jax.lax.dynamic_index_in_dim(ai, jnp.clip(i - 1, 0, LA - 1),
                                          axis=1, keepdims=True)
        bc = jnp.take_along_axis(bi, jnp.clip(j - 1, 0, LB - 1), axis=1)
        sub = jnp.where((ac == bc) & (ac < 4) & (bc < 4), match, mismatch)
        okj = (j >= 1) & (j <= blen[:, None])
        m = jnp.where(okj, hdg + sub, NEG)
        e = eup
        # h = max(m, e, f); d bits 0-1
        d = jnp.where(m >= e, jnp.uint8(0), jnp.uint8(1))
        h = jnp.maximum(m, e)
        f = fscan(jnp.where(okj, m, NEG))
        use_f = f > h
        d = jnp.where(use_f, jnp.uint8(2), d)
        h = jnp.maximum(h, f)
        # next E (consumes a): max(e + ext, m + open_i + ext); bit2 if extend
        e_ext = e + ext_
        e_open = m + jnp.int32(open_i) + ext_
        d = d | jnp.where(e_ext > e_open, jnp.uint8(1 << 2), jnp.uint8(0))
        e_next = jnp.maximum(e_ext, e_open)
        # F extend flag (bits 4-5 = 2 when the del lane extended): the
        # f-scan already folded extension; mark cells where f came from
        # further than one column back.  Recompute one-step f for the flag:
        f1 = jnp.concatenate(
            [jnp.full((B, 1), NEG),
             (jnp.where(okj, m, NEG) + jnp.int32(open_d) + ext_)[:, :-1]],
            axis=1,
        )
        d = d | jnp.where(f > f1, jnp.uint8(2 << 4), jnp.uint8(0))
        # out-of-range rows
        oki = i <= alen[:, None]
        h = jnp.where(okj & oki, h, NEG)
        e_next = jnp.where(oki, e_next, NEG)
        return (h, e_next), (h, d)

    # UNROLL rows per scan step (see ops/banded.py): wall-clock is bound
    # by sequential step count, not the tiny per-row FLOPs.  Only the
    # direction plane is stacked; each read's final H row is captured in
    # the carry (stacking H too doubled the DP's HBM footprint).
    UNROLL = 4 if LA % 4 == 0 else (2 if LA % 2 == 0 else 1)

    def step(carry, i0):
        c, hold = carry
        ds_u = []
        for u in range(UNROLL):
            i = i0 * UNROLL + u + 1
            c, (h_u, d_u) = row_update(c, i)
            hold = jnp.where(i == alen[:, None], h_u, hold)
            ds_u.append(d_u)
        return (c, hold), jnp.stack(ds_u)

    iters = jnp.arange(0, LA // UNROLL, dtype=jnp.int32)
    ((hl, _el), hold), ds = jax.lax.scan(step, ((h0, e0), h0), iters)
    ds = ds.reshape(LA, B, W)
    d0 = jnp.zeros((B, W), jnp.uint8)
    dirs = jnp.concatenate([d0[None], ds], axis=0)   # [LA+1, B, W]
    bidx = jnp.arange(B)
    lane_end = blen - base[bidx, alen]
    score = jnp.take_along_axis(
        hold, jnp.clip(lane_end, 0, W - 1)[:, None], axis=1)[:, 0]
    score = jnp.where((lane_end >= 0) & (lane_end < W), score, NEG)
    return score, jnp.transpose(dirs, (1, 0, 2))


def band_from_cigar(cigars, alens, blens, LA: int, W: int) -> np.ndarray:
    """Per-row leftmost band columns following a prior CIGAR path.

    cigars: per pair (ops, counts) with ops in M/I/D (I consumes a).
    Mirrors the reference's band construction (kswx.h:562-600) with a
    fixed width W; monotone non-decreasing so row shifts are >= 0.
    """
    B = len(cigars)
    base = np.zeros((B, LA + 1), np.int32)
    for i, (ops, counts) in enumerate(cigars):
        al, bl = int(alens[i]), int(blens[i])
        centers = np.zeros(al + 1, np.int64)
        qx = tx = 0
        for op, ln in zip(ops, counts):
            ln = int(ln)
            if op == "M":
                w = max(0, min(ln, al - qx))
                centers[qx + 1: qx + w + 1] = tx + np.arange(1, w + 1)
                qx += ln
                tx += ln
            elif op == "I":
                w = max(0, min(ln, al - qx))
                centers[qx + 1: qx + w + 1] = tx
                qx += ln
            else:  # D
                tx += ln
                if qx <= al:
                    centers[qx] = tx
            if qx >= al:
                qx = min(qx, al)
        if qx < al:  # prior cigar shorter than a: extend diagonally
            centers[qx + 1:] = centers[qx] + np.arange(1, al - qx + 1)
        rows = np.minimum(np.arange(LA + 1), al)
        c = centers[rows]
        b_ = np.clip(c - W // 2, 0, max(0, bl))
        np.maximum.accumulate(b_, out=b_)
        base[i] = b_
    return base


def traceback_refine(dirs, base: np.ndarray, alen, blen):
    """Reference traceback state machine (kswx.h:636-655), run on device.

    dirs may be a device array (preferred — only the [steps, B] move
    stream is fetched) or numpy.  Returns per pair (ops, counts)."""
    from .traceback import rle_moves, tb_refine_device

    B, LR, W = dirs.shape
    T = 2 * LR + W + 4
    mvs = np.asarray(tb_refine_device(
        jnp.asarray(dirs), jnp.asarray(base),
        jnp.asarray(np.asarray(alen, np.int32)),
        jnp.asarray(np.asarray(blen, np.int32)), T=T))
    code2op = {0: "M", 1: "I", 2: "D"}
    return [rle_moves(mvs[:, b], code2op, 3) for b in range(B)]


def refine_alignment_batch(pairs, cigars, *, W_base: int = 64, match: int = 2,
                           mismatch: int = -5, open_i: int = -3,
                           open_d: int = -3, ext: int = -1):
    """Refine a batch of alignments around their prior CIGARs.

    pairs: list of (a_codes, b_codes) numpy uint8 arrays (already
    oriented and sliced to the aligned region, reference qb/tb..qe/te).
    cigars: list of (ops, counts) prior CIGARs in the same coordinates.

    Returns list of dicts: {score, ops, counts, mat, mis, ins, dl, aln}.
    Mirrors kswx_refine_alignment's outputs (kswx.h:633-657).
    """
    if not pairs:
        return []
    B = len(pairs)
    alens = np.array([len(a) for a, _ in pairs], np.int32)
    blens = np.array([len(b) for _, b in pairs], np.int32)
    # band tier: base W + the largest indel run of the prior cigar
    # (the reference widens by the run length around each indel)
    wmax = W_base
    for ops, counts in cigars:
        for op, ln in zip(ops, counts):
            if op != "M":
                wmax = max(wmax, W_base + 2 * int(ln))
    W = 1 << max(6, (min(wmax, 1024) - 1).bit_length())
    LA = 1 << max(8, (int(alens.max()) - 1).bit_length())
    LB = int(blens.max()) + 1
    a = np.full((B, LA), 4, np.uint8)
    b = np.full((B, LB), 4, np.uint8)
    for k, (ac, bc) in enumerate(pairs):
        a[k, : len(ac)] = ac
        b[k, : len(bc)] = bc
    base = band_from_cigar(cigars, alens, blens, LA, W)
    score, dirs = refine_banded_affine(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(alens), jnp.asarray(blens),
        jnp.asarray(base), LA=LA, W=W, match=match, mismatch=mismatch,
        open_i=open_i, open_d=open_d, ext=ext,
    )
    score = np.asarray(score)
    new_cigars = traceback_refine(dirs, base, alens, blens)
    out = []
    for k, (ops, counts) in enumerate(new_cigars):
        ac, bc = pairs[k]
        x = y = mat = mis = ins = dl = 0
        for op, ln in zip(ops, counts):
            if op == "M":
                seg = int(np.sum(ac[x: x + ln] == bc[y: y + ln]))
                mat += seg
                mis += ln - seg
                x += ln
                y += ln
            elif op == "I":
                ins += ln
                x += ln
            else:
                dl += ln
                y += ln
        out.append(dict(score=int(score[k]), ops=ops, counts=counts,
                        mat=mat, mis=mis, ins=ins, dl=dl,
                        aln=mat + mis + ins + dl))
    return out
