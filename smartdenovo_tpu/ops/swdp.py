"""Batched banded alignment DP — anti-diagonal wavefront on device.

Batched device replacement for the reference's DP cell loops (ksw.c SSE2
Smith-Waterman, kswx.h:101-232 banded extension, kswx.h:483-659 refine).
Instead of per-pair SIMD lanes over one sequence, whole *batches* of
small alignment sub-problems run as one wavefront: sequences are cut at
z-mer anchors into windows (the reference does the same, SURVEY.md §5.7),
and each anti-diagonal step updates a [B, L] tile on the VPU.  Direction
bits stream to HBM; traceback is a vectorised host pass (O(B) per step).

Scoring matches the reference defaults M=2 X=-5 O=-3 E=-1 in linear-gap
form (gap = O; the reference's banded windows are small enough that
affine vs linear rarely changes consensus — revisit with affine E/F
lanes when the zmo CIGAR engine lands).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

NEG_INF = jnp.int32(-(1 << 28))

# traceback codes
DIAG, UP, LEFT, STOP = 1, 2, 3, 0


@functools.partial(jax.jit, static_argnames=("max_len", "match", "mismatch", "gap"))
def batch_global_align(
    a: jnp.ndarray,      # [B, L] uint8 codes (PAD=4 beyond length)
    b: jnp.ndarray,      # [B, L] uint8
    alen: jnp.ndarray,   # [B] int32
    blen: jnp.ndarray,   # [B] int32
    *,
    max_len: int,
    match: int = 2,
    mismatch: int = -5,
    gap: int = -3,
):
    """Global (Needleman-Wunsch) alignment of B pairs via wavefront.

    Returns (score [B], dirs [B, 2*max_len+1, max_len+1] uint8) where
    dirs[d, i] is the move for cell (row=i, col=d-i) on anti-diagonal d.
    """
    B, L = a.shape
    assert L == max_len
    W = max_len + 1  # cells indexed by row i in [0, W)
    ai = a.astype(jnp.int32)
    bi = b.astype(jnp.int32)

    rows = jnp.arange(W, dtype=jnp.int32)  # i = position in a (row)

    def step(carry, d):
        hm2, hm1 = carry  # H on diagonals d-2, d-1; shape [B, W]
        i = rows[None, :]
        j = d - i  # column (position in b)
        inb = (i >= 0) & (i <= alen[:, None]) & (j >= 0) & (j <= blen[:, None])
        # candidates
        up = jnp.where(i > 0, jnp.roll(hm1, 1, axis=1), NEG_INF) + gap      # from (i-1, j)
        left = hm1 + gap                                                     # from (i, j-1)
        ac = jnp.take_along_axis(ai, jnp.clip(i - 1, 0, L - 1), axis=1)
        bc = jnp.take_along_axis(bi, jnp.clip(j - 1, 0, L - 1), axis=1)
        sub = jnp.where((ac == bc) & (ac < 4), match, mismatch)
        dg = jnp.where((i > 0) & (j > 0), jnp.roll(hm2, 1, axis=1), NEG_INF) + sub
        h = jnp.maximum(dg, jnp.maximum(up, left))
        dirc = jnp.where(
            h == dg, jnp.uint8(DIAG), jnp.where(h == up, jnp.uint8(UP), jnp.uint8(LEFT))
        )
        # boundary conditions
        origin = (i == 0) & (j == 0)
        first_row = (i == 0) & (j > 0)
        first_col = (j == 0) & (i > 0)
        h = jnp.where(origin, 0, h)
        h = jnp.where(first_row, gap * j, h)
        h = jnp.where(first_col, gap * i, h)
        dirc = jnp.where(origin, jnp.uint8(STOP), dirc)
        dirc = jnp.where(first_row, jnp.uint8(LEFT), dirc)
        dirc = jnp.where(first_col, jnp.uint8(UP), dirc)
        h = jnp.where(inb, h, NEG_INF)
        dirc = jnp.where(inb, dirc, jnp.uint8(STOP))
        return (hm1, h), (h, dirc)

    init = (jnp.full((B, W), NEG_INF), jnp.full((B, W), NEG_INF))
    ds = jnp.arange(2 * max_len + 1, dtype=jnp.int32)
    (_, _), (hs, dirs) = jax.lax.scan(step, init, ds)
    # final score at (alen, blen): diagonal d = alen + blen, row = alen
    d_end = alen + blen
    score = hs[d_end, jnp.arange(B), alen]
    return score, jnp.transpose(dirs, (1, 0, 2))


def traceback_batch(dirs: np.ndarray, alen: np.ndarray, blen: np.ndarray):
    """Vectorised host traceback.  Returns list of (ops, counts) per pair —
    a run-length CIGAR-like encoding with ops in {'M','I','D'} where I is
    an insertion in `a` (consumes a) and D consumes b."""
    dirs = np.asarray(dirs)
    B = dirs.shape[0]
    i = alen.astype(np.int64).copy()
    j = blen.astype(np.int64).copy()
    done = (i == 0) & (j == 0)
    paths = [[] for _ in range(B)]
    maxsteps = dirs.shape[1]
    bidx = np.arange(B)
    for _ in range(maxsteps):
        if done.all():
            break
        d = i + j
        mv = dirs[bidx, d, i]
        mv = np.where(done, 0, mv)
        for k in np.nonzero(mv)[0]:
            paths[k].append(int(mv[k]))
        step_i = (mv == DIAG) | (mv == UP)
        step_j = (mv == DIAG) | (mv == LEFT)
        i -= step_i
        j -= step_j
        done = (i <= 0) & (j <= 0)
    out = []
    code2op = {DIAG: "M", UP: "I", LEFT: "D"}
    for path in paths:
        path.reverse()
        ops, counts = [], []
        for c in path:
            op = code2op[c]
            if ops and ops[-1] == op:
                counts[-1] += 1
            else:
                ops.append(op)
                counts.append(1)
        out.append((ops, counts))
    return out


def align_strings(a_codes, b_codes, ops, counts):
    """Expand a traceback into aligned strings over codes, with '-' = 4."""
    ra, rb = [], []
    ia = ib = 0
    for op, cnt in zip(ops, counts):
        for _ in range(cnt):
            if op == "M":
                ra.append(a_codes[ia]); rb.append(b_codes[ib]); ia += 1; ib += 1
            elif op == "I":
                ra.append(a_codes[ia]); rb.append(4); ia += 1
            else:
                ra.append(4); rb.append(b_codes[ib]); ib += 1
    return np.array(ra, np.uint8), np.array(rb, np.uint8)
