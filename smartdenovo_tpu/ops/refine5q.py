"""Quality-aware refine alignment — batched banded min-cost DP on device.

Batched device equivalent of `kswx_refine_affine_alignment_5q` (reference
kswx.h:871-1075), the wtcns refine pass used when the layout carries f5q
7-track qualities (wtcns.c:372-381).  Costs (uint8, smaller = better):

  substitution of query base i by target base b:
      0 if b == query[i]; SubQV[i] if b == SubTag[i]; QMIS otherwise
  insertion (consume query base i):   InsQV[i+1]  (open AND extend — the
      reference's QEXT line for the E lane is commented out, kswx.h:1020)
  deletion of target base b at row i: DelQV[i+1] if b == DelTag[i+1]
      else QDEL; extension QEXT
  clip: QCLP per unaligned edge base (both sequences)

Defaults follow wtcns.c:104-107 (uint8 wrap of -5,-20,-15,-5).

Implementation mirrors ops/refine.py (fixed-W band around the prior
CIGAR path, rows batched [B, W], in-row deletion lane as an associative
min-plus scan); scores are negated so the kernel maximizes like its
unweighted sibling.  Track layout per read: [7, L] with tracks 0-4 =
phred values, 5-6 = 2-bit base codes (file_reader f5q, wtcns
push5q_wtcns, wtcns.c:172-186).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .refine import band_from_cigar, traceback_refine

NEG = jnp.int32(-(1 << 24))

QCLP = 251   # uint8 wrap of -5  (wtcns.c:104)
QMIS = 236   # uint8 wrap of -20 (wtcns.c:105)
QDEL = 241   # uint8 wrap of -15 (wtcns.c:106)
QEXT = 251   # uint8 wrap of -5  (wtcns.c:107)


@functools.partial(
    jax.jit,
    static_argnames=("LA", "W", "qclp", "qmis", "qdel", "qext"),
)
def refine5q_banded(
    a: jnp.ndarray,        # [B, LA] uint8 query codes
    b: jnp.ndarray,        # [B, LB] uint8 target codes
    subqv: jnp.ndarray,    # [B, LA] int32 track 1
    insqv: jnp.ndarray,    # [B, LA] int32 track 2
    delqv: jnp.ndarray,    # [B, LA] int32 track 3
    subtag: jnp.ndarray,   # [B, LA] int32 track 5 (base code)
    deltag: jnp.ndarray,   # [B, LA] int32 track 6 (base code)
    alen: jnp.ndarray,     # [B] int32
    blen: jnp.ndarray,     # [B] int32
    base: jnp.ndarray,     # [B, LA+1] int32 leftmost band column per row
    *,
    LA: int,
    W: int = 128,
    qclp: int = QCLP,
    qmis: int = QMIS,
    qdel: int = QDEL,
    qext: int = QEXT,
):
    """Returns (score [B] — negated total cost, dirs [B, LA+1, W])."""
    B = a.shape[0]
    LB = b.shape[1]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]
    ai = a.astype(jnp.int32)
    bi = b.astype(jnp.int32)

    def fscan(m_open):
        # F[c] = max_{k<c} open[k] + (-qext)*(c-k)
        def comb(x, y):
            vx, nx = x
            vy, ny = y
            return jnp.maximum(vx - jnp.int32(qext) * ny, vy), nx + ny

        ones = jnp.ones_like(m_open)
        s, _ = jax.lax.associative_scan(comb, (m_open, ones), axis=1)
        return jnp.concatenate([jnp.full((B, 1), NEG), s[:, :-1]], axis=1)

    def row0():
        j = base[:, 0:1] + lanes
        h = jnp.where(j >= 0, -j * jnp.int32(qclp), NEG)  # target clip
        ok = (j >= 0) & (j <= blen[:, None])
        return jnp.where(ok, h, NEG)

    h0 = row0()
    e0 = jnp.full((B, W), NEG)

    def row_costs(i):
        ic = jnp.clip(i - 1, 0, LA - 1)
        qb = jax.lax.dynamic_index_in_dim(ai, ic, axis=1, keepdims=True)
        st = jax.lax.dynamic_index_in_dim(subtag, ic, axis=1, keepdims=True)
        sq = jax.lax.dynamic_index_in_dim(subqv, ic, axis=1, keepdims=True)
        # ins/del costs come from the NEXT query base (kswx.h:1003-1011);
        # at the last row they become clip costs
        nxt = jnp.clip(i, 0, LA - 1)
        iq = jax.lax.dynamic_index_in_dim(insqv, nxt, axis=1, keepdims=True)
        dq = jax.lax.dynamic_index_in_dim(delqv, nxt, axis=1, keepdims=True)
        dt = jax.lax.dynamic_index_in_dim(deltag, nxt, axis=1, keepdims=True)
        last = i >= alen[:, None]
        iq = jnp.where(last, jnp.int32(qclp), iq)
        return qb, st, sq, iq, dq, dt, last

    def row_update(carry, i):
        hprev, eprev = carry
        bs = jax.lax.dynamic_index_in_dim(base, i, axis=1, keepdims=False)
        bp = jax.lax.dynamic_index_in_dim(base, i - 1, axis=1, keepdims=False)
        shift = (bs - bp)[:, None]
        j = bs[:, None] + lanes
        idx_up = lanes + shift
        idx_dg = lanes + shift - 1

        def shifted(x, idx):
            return jnp.where(
                (idx >= 0) & (idx < W),
                jnp.take_along_axis(x, jnp.clip(idx, 0, W - 1), axis=1),
                NEG,
            )

        hup = shifted(hprev, idx_up)
        hdg = shifted(hprev, idx_dg)
        eup = shifted(eprev, idx_up)
        qb, st, sq, iq, dq, dt, last = row_costs(i)
        bc = jnp.take_along_axis(bi, jnp.clip(j - 1, 0, LB - 1), axis=1)
        sub = jnp.where(bc == qb, 0,
                        jnp.where(bc == st, sq, jnp.int32(qmis)))
        delc = jnp.where(last, jnp.int32(qclp),
                         jnp.where(bc == dt, dq, jnp.int32(qdel)))
        okj = (j >= 1) & (j <= blen[:, None])
        m = jnp.where(okj, hdg - sub, NEG)
        e = eup
        d = jnp.where(m >= e, jnp.uint8(0), jnp.uint8(1))
        h = jnp.maximum(m, e)
        f = fscan(jnp.where(okj, m - delc, NEG))
        use_f = f > h
        d = jnp.where(use_f, jnp.uint8(2), d)
        h = jnp.maximum(h, f)
        # E lane (insertion): open and extend both cost iq (kswx.h:1020)
        e_ext = e - iq
        e_open = m - iq
        d = d | jnp.where(e_ext > e_open, jnp.uint8(1 << 2), jnp.uint8(0))
        e_next = jnp.maximum(e_ext, e_open)
        # F extension flag: f came from further than one column back
        f1 = jnp.concatenate(
            [jnp.full((B, 1), NEG),
             jnp.where(okj, m - delc, NEG)[:, :-1]],
            axis=1,
        )
        d = d | jnp.where(f > f1, jnp.uint8(2 << 4), jnp.uint8(0))
        # query-clip entry at column 0 (reference h1 = i*QCLP, kswx.h:992):
        # the traceback treats leading rows above the start as clip/ins
        at0 = j == 0
        h = jnp.where(at0, -i * jnp.int32(qclp), h)
        d = jnp.where(at0, jnp.uint8(1), d)
        oki = i <= alen[:, None]
        h = jnp.where(oki, h, NEG)
        h = jnp.where(okj | at0, h, NEG)
        e_next = jnp.where(oki, e_next, NEG)
        return (h, e_next), (h, d)

    # UNROLL rows per scan step (see ops/banded.py); only the direction
    # plane is stacked — each read's final H row rides the carry
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
    dirs = jnp.concatenate([d0[None], ds], axis=0)
    bidx = jnp.arange(B)
    lane_end = blen - base[bidx, alen]
    score = jnp.take_along_axis(
        hold, jnp.clip(lane_end, 0, W - 1)[:, None], axis=1)[:, 0]
    score = jnp.where((lane_end >= 0) & (lane_end < W), score, NEG)
    return score, jnp.transpose(dirs, (1, 0, 2))


def refine5q_alignment_batch(pairs, quals, cigars, *, W_base: int = 64,
                             qclp: int = QCLP, qmis: int = QMIS,
                             qdel: int = QDEL, qext: int = QEXT):
    """Quality-aware refine of a batch of alignments around prior CIGARs.

    pairs: list of (a_codes, b_codes) oriented aligned-region slices.
    quals: list of [7, len(a)] uint8 track arrays (tracks 0-4 phred,
           5-6 base codes), oriented like `a`.
    cigars: list of (ops, counts) prior CIGARs ('I' consumes a).

    Returns list of dicts {score, ops, counts, mat, mis, ins, dl, aln}
    mirroring ops.refine.refine_alignment_batch.
    """
    if not pairs:
        return []
    B = len(pairs)
    alens = np.array([len(a) for a, _ in pairs], np.int32)
    blens = np.array([len(b) for _, b in pairs], np.int32)
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
    qv = np.zeros((B, 5, LA), np.int32)   # subqv insqv delqv subtag deltag
    for k, ((ac, bc), qk) in enumerate(zip(pairs, quals)):
        a[k, : len(ac)] = ac
        b[k, : len(bc)] = bc
        qv[k, 0, : len(ac)] = qk[1, : len(ac)]
        qv[k, 1, : len(ac)] = qk[2, : len(ac)]
        qv[k, 2, : len(ac)] = qk[3, : len(ac)]
        qv[k, 3, : len(ac)] = qk[5, : len(ac)]
        qv[k, 4, : len(ac)] = qk[6, : len(ac)]
    base = band_from_cigar(cigars, alens, blens, LA, W)
    score, dirs = refine5q_banded(
        jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(qv[:, 0]), jnp.asarray(qv[:, 1]), jnp.asarray(qv[:, 2]),
        jnp.asarray(qv[:, 3]), jnp.asarray(qv[:, 4]),
        jnp.asarray(alens), jnp.asarray(blens), jnp.asarray(base),
        LA=LA, W=W, qclp=qclp, qmis=qmis, qdel=qdel, qext=qext,
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
