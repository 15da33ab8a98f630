"""Dot-matrix overlap alignment — batched device kernels (SW-free).

Data-parallel reimplementation of the reference's dot-matrix mode
(hzm_aln.h:721-1181 denoising_hzmps / fast_merge_wtseedv /
chaining_overhang_wtseedv / dot_matrix_align_hzmps), the engine behind
`wtzmo -U` (run_dmo.sh).  Differences from the reference are deliberate
device-first redesigns with equivalent behaviour:

  - the reference's overlapping diagonal windows + union-find group merge
    becomes single-linkage clustering on sorted (diagonal, position) keys
    (break when the diagonal gap exceeds yvar / the x-gap exceeds xvar) —
    computed with sorts + segmented scans instead of pointer chasing;
  - seed pairs for a whole batch of (query, candidate) pairs are produced
    by one budgeted expansion of the global z-mer posting index filtered
    by candidate membership (replacing per-candidate re-scans of
    query_single_read_seeds, hzm_aln.h:173-224);
  - the O(n^2) block chaining DP (hzm_aln.h:1056-1132) runs as one dense
    [pairs, NB] vectorised scan.

Outputs feed the same 17-column overlap records as the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .flatseeds import RM_BLK

INT32_MAX = jnp.int32(0x7FFFFFFF)
NEG_BIG = jnp.int32(-1000000)


# ---------------------------------------------------------------------------
# phase 2: seed-pair extraction against the zmer index
# ---------------------------------------------------------------------------


class PairBatch(NamedTuple):
    pair_id: jnp.ndarray  # [PB] int32 = ((q*A + slot)*2 + dir), BIGP if dead
    o1l1: jnp.ndarray     # [PB] int32 query raw offset<<8 | span (<=255)
    o2l2: jnp.ndarray     # [PB] int32 candidate offset<<8 | span (flipped)
    match_cnt: jnp.ndarray  # [Q*A*2] int32 seed matches per pair (pre-budget)
    total: jnp.ndarray    # scalar: pairs before pair-budget truncation
    expand_total: jnp.ndarray  # scalar: posting expansion size before budget


def _search_rows_pos(table, row_ids, values):
    """Position of value in per-row sorted table [Q, A]; returns (pos, found)."""
    A = table.shape[1]
    steps = max(1, (A - 1).bit_length())
    lo = jnp.zeros(values.shape, jnp.int32)
    hi = jnp.full(values.shape, A, jnp.int32)
    for _ in range(steps + 1):
        mid = (lo + hi) >> 1
        mv = table[row_ids, jnp.clip(mid, 0, A - 1)]
        go = (mv < values) & (mid < hi)
        lo = jnp.where(go, mid + 1, lo)
        hi = jnp.where(go, hi, jnp.where(mid < hi, mid, hi))
    pos = jnp.clip(lo, 0, A - 1)
    found = table[row_ids, pos] == values
    return pos, found


@functools.partial(jax.jit, static_argnames=("expand_budget", "pair_budget", "kvar"))
def extract_zmer_pairs(
    qz: jnp.ndarray,     # [Q, L] uint32 query zmers
    qdir: jnp.ndarray,   # [Q, L] bool
    qoff: jnp.ndarray,   # [Q, L] int32
    qspan: jnp.ndarray,  # [Q, L] int32
    qvalid: jnp.ndarray, # [Q, L] bool
    qrids: jnp.ndarray,  # [Q] int32
    cands_sorted: jnp.ndarray,  # [Q, A] int32 candidate ids sorted asc (pad INT32_MAX)
    zmers: jnp.ndarray, post_rd: jnp.ndarray, post_packed: jnp.ndarray,
    read_lens: jnp.ndarray,  # [R] int32
    *,
    expand_budget: int,
    pair_budget: int,
    kvar: int = 2,
) -> PairBatch:
    """Budgeted z-mer match extraction, structured to minimise random
    gathers (the expansion touches every posting ~freq times).  Two-phase
    layout:

      phase 1 (width = expand_budget): 3 gathers per expanded element —
        a packed int64 (range start in the posting array | output range
        start), the posting's read id, and a per-(query, read) slot table
        that folds the candidate membership test AND the candidate read
        length into one int32.  Non-candidate hits (the vast majority at
        scale) die here, before any field gathers.
      phase 2 (width = pair_budget): survivors only — 2 gathers (packed
        query fields, packed posting fields) compute coordinates and the
        kvar span filter.

    Replaces the reference's per-pair zmer heap merge (hzm_aln.h:173)."""
    from .flatops import bounded_bisect

    Q, L = qz.shape
    A = cands_sorted.shape[1]
    assert A <= 511, "slot packing uses 9 bits; keep dm_cand <= 511"
    R = read_lens.shape[0]
    P = post_rd.shape[0]
    # dense (q, read) -> (clen<<9 | slot+1) lookup: one gather answers both
    # "is this read a candidate of q" and "how long is it"
    qq = jnp.broadcast_to(jnp.arange(Q, dtype=jnp.int32)[:, None], cands_sorted.shape)
    col = jnp.where((cands_sorted >= 0) & (cands_sorted < R), cands_sorted, R)
    clen_cand = read_lens[jnp.clip(col, 0, R - 1)].astype(jnp.int32)
    slot_val = (clen_cand << 9) | jnp.broadcast_to(
        jnp.arange(1, A + 1, dtype=jnp.int32)[None, :], cands_sorted.shape
    )
    slot_ctab = (
        jnp.zeros((Q, R + 1), jnp.int32)
        .at[qq, col]
        .set(slot_val, mode="drop")[:, :R]
    )
    BIGP = jnp.int32(Q * A * 2)
    flat_z = qz.reshape(-1)
    flat_valid = qvalid.reshape(-1)
    q_of = (jnp.arange(Q * L, dtype=jnp.int32) // L).astype(jnp.int32)
    start = jnp.searchsorted(zmers, flat_z, side="left").astype(jnp.int32)
    end = jnp.searchsorted(zmers, flat_z, side="right").astype(jnp.int32)
    # global repeat guard: mega-frequency zmers would waste the whole
    # expansion budget (the reference's per-read cap bounds these too)
    zmax_global = 4096
    rng_ok = (end - start) <= zmax_global
    # own-read membership (the per-read zmer cap kept this (read, zmer)
    # group): bisect the read id inside the zmer's posting range.  This
    # runs on the [Q*Z] query-zmer axis (~100K), not the expanded axis,
    # so it is cheap; it keeps query/index cap symmetry (wtzmo.c:433).
    own_lb = bounded_bisect(post_rd, qrids[q_of], start, end, 13)
    own_ok = (own_lb < end) & (
        post_rd[jnp.clip(own_lb, 0, post_rd.shape[0] - 1)] == qrids[q_of]
    )
    cnt = jnp.where(flat_valid & own_ok & rng_ok, end - start, 0)
    # packed query fields: off<<9 | min(span,255)<<1 | dir (elementwise, free)
    qpk = (
        (qoff.reshape(-1).astype(jnp.int32) << 9)
        | (jnp.minimum(qspan.reshape(-1), 255).astype(jnp.int32) << 1)
        | qdir.reshape(-1).astype(jnp.int32)
    )

    # ---- phase 1: inlined expand_ranges with a packed (out_start | post_
    # start) fill value so range mapping costs ONE int64 gather
    cum = jnp.cumsum(cnt)
    total_exp = cum[-1]
    ostarts = cum - cnt  # output range start per query zmer
    nsrc = cnt.shape[0]
    idx = jnp.where(cnt > 0, jnp.clip(ostarts, 0, expand_budget), expand_budget)
    mark = (
        jnp.zeros(expand_budget + 1, jnp.int32)
        .at[idx]
        .max(jnp.arange(1, nsrc + 1, dtype=jnp.int32), mode="drop")[:expand_budget]
    )
    src = jax.lax.cummax(mark) - 1
    src_c = jnp.clip(src, 0, nsrc - 1)
    # one 2-wide gather maps each slot to (output range start, posting
    # range start); x64 is off so a packed int64 would truncate
    rtab = jnp.stack([ostarts, start], axis=1)        # [nsrc, 2] int32
    g = rtab[src_c]                                   # gather 1
    p = jnp.arange(expand_budget, dtype=jnp.int32)
    within = p - g[:, 0]
    pidx = jnp.clip(g[:, 1] + within, 0, P - 1)
    alive = (p < total_exp) & (src >= 0)
    c_rd = post_rd[pidx]                              # gather 2
    sv = slot_ctab[src_c // L, jnp.clip(c_rd, 0, R - 1)]  # gather 3
    keep = alive & ((sv & 0x1FF) > 0)
    # compact slot-filter survivors into [pair_budget]
    dst = jnp.cumsum(keep.astype(jnp.int32)) - 1
    total = dst[-1] + 1
    dst = jnp.where(keep & (dst < pair_budget), dst, pair_budget)
    def scat(vals, fill):
        return (
            jnp.full(pair_budget + 1, fill, jnp.int32)
            .at[dst]
            .set(vals.astype(jnp.int32), mode="drop")[:pair_budget]
        )
    src2 = scat(src_c, 0)
    pidx2 = scat(pidx, 0)
    sv2 = scat(sv, 0)
    live2 = scat(jnp.ones_like(src_c), 0) > 0

    # ---- phase 2: field gathers on survivors only
    qg = qpk[src2]                                    # gather 4 (pbud wide)
    ppk = post_packed[pidx2]                          # gather 5 (pbud wide)
    q_span = (qg >> 1) & 0xFF
    p_off = ppk >> 9
    p_span = (ppk >> 1) & 0xFF
    len_ok = live2 & (jnp.abs(q_span - p_span) <= kvar)
    pairdir = (qg ^ ppk) & 1
    clen = sv2 >> 9
    slot = (sv2 & 0x1FF) - 1
    o2 = jnp.where(pairdir == 1, clen - (p_off + p_span), p_off)
    pair_id = jnp.where(len_ok, ((src2 // L) * A + slot) * 2 + pairdir, BIGP)
    return PairBatch(
        pair_id=pair_id,
        o1l1=qg >> 1,
        o2l2=(o2 << 8) | p_span,
        match_cnt=jnp.zeros(Q * A * 2, jnp.int32),  # filled by dot_matrix_align
        total=total,
        expand_total=total_exp,
    )


def _emit_runs(key, pay, aux, *, max_per_read: int, pair_budget: int):
    """Phase 3 of the sort-join: n x m emission from the sorted stream.

    key is (group << 1 | side), sorted, with a group's query entries
    (side 0) before its candidate entries (side 1) and INT32_MAX for dead
    entries.  Each candidate entry whose group holds 1 <= n < max_per_read
    query entries owns a CONTIGUOUS run of n output slots: its payload is
    scattered to the run's first slot, then forward-filled over the gaps.
    Returns per-slot (candidate pay, candidate aux, base, alive, total):
    slot p pairs its candidate entry with query entry base[p] + p, counted
    among the stream's live query entries in order.
    """
    p2 = jnp.arange(pair_budget, dtype=jnp.int32)
    svalid = key != INT32_MAX
    tag1 = svalid & ((key & 1) == 1)
    tag0 = svalid & ((key & 1) == 0)
    grp = key >> 1
    run_new = jnp.concatenate([jnp.ones(1, bool), grp[1:] != grp[:-1]])
    pre0 = jnp.cumsum(tag0.astype(jnp.int32)) - tag0.astype(jnp.int32)
    pre0_rs = jax.lax.cummax(jnp.where(run_new, pre0, -1))  # monotone
    qcnt = pre0 - pre0_rs
    cnt2 = jnp.where(tag1 & (qcnt > 0) & (qcnt < max_per_read), qcnt, 0)
    cum2 = jnp.cumsum(cnt2)
    total2 = cum2[-1]
    ost2 = cum2 - cnt2
    base_val = pre0_rs - ost2   # query occurrence j of a run lives at
                                # compact query index base_val + slot
    start_idx = jnp.where(cnt2 > 0, jnp.minimum(ost2, pair_budget),
                          pair_budget)

    def at_start(vals, fill):
        return (jnp.full(pair_budget + 1, fill, jnp.int32)
                .at[start_idx].set(vals.astype(jnp.int32),
                                   mode="drop")[:pair_budget])

    cgs = at_start(pay, 0)                      # candidate pk per run
    auxs = at_start(aux, 0)                     # (q*A + slot) per run
    bases = at_start(base_val, 0)
    filled = at_start(jnp.ones_like(cnt2), 0) > 0
    sh = 1
    while sh < max_per_read:                    # runs are < max_per_read
        take = ~filled

        def sr(x):
            return jnp.concatenate([jnp.zeros(sh, x.dtype), x[:-sh]])

        cgs = jnp.where(take, sr(cgs), cgs)
        auxs = jnp.where(take, sr(auxs), auxs)
        bases = jnp.where(take, sr(bases), bases)
        filled = filled | sr(filled)
        sh *= 2
    alive2 = (p2 < total2) & filled
    return cgs, auxs, bases, alive2, total2


@functools.partial(
    jax.jit,
    static_argnames=("expand_budget", "pair_budget", "kvar", "zbits",
                     "max_per_read", "qprobe_budget"),
)
def extract_zmer_pairs_join(
    qz: jnp.ndarray,     # [Q, L] uint32 query zmers
    qdir: jnp.ndarray,   # [Q, L] bool
    qoff: jnp.ndarray,   # [Q, L] int32
    qspan: jnp.ndarray,  # [Q, L] int32
    qvalid: jnp.ndarray, # [Q, L] bool
    cands_sorted: jnp.ndarray,  # [Q, A] int32 candidate read ids (pad INT32_MAX)
    rm_zsd: jnp.ndarray,  # [P] int32 zmer<<9|span<<1|dir, read-major ALIGNED
    rm_pk: jnp.ndarray,   # [P] int32 off<<9|span<<1|dir, same layout
    rm_start: jnp.ndarray,  # [R+1] int32 RM_BLK-aligned CSR per read
    read_lens: jnp.ndarray,  # [R] int32
    *,
    expand_budget: int,   # >= total ALIGNED candidate zmer entries, RM_BLK mult
    pair_budget: int,
    kvar: int = 2,
    zbits: int = 20,      # 2*zsize
    max_per_read: int = 16,
    qprobe_budget: int = 0,   # 0 = no query-side compaction (Q*L wide)
) -> PairBatch:
    """Per-pair z-mer intersection via one global sort (scalable matcher).

    Unlike `extract_zmer_pairs` (posting expansion, cost ~ sum of global
    zmer frequencies — quadratic in genome size at fixed coverage), this
    joins each query's zmer list against ONLY its candidates' lists:

      1. expand every (query, candidate) pair into the candidate's
         read-major posting slice.  Slices are RM_BLK-aligned (flatseeds
         index layout), so the expansion runs at BLOCK granularity:
         per-block source bookkeeping at budget/RM_BLK width, then one
         row-gather of [P/RM_BLK, RM_BLK] tables per field instead of
         per-element gathers;
      2. one global sort of [query entries + candidate entries] keyed by
         (query, zmer, side) groups matching zmers into runs with the
         query occurrences first.  Candidate payloads (pk, flipped-offset
         pk) ride through the sort so phase 3 never touches rm_* again;
      3. per candidate entry, the run's query-occurrence count n is a
         prefix-sum difference (no gathers); a second budgeted expansion
         emits the n x m cross product of co-occurrences.

    The per-read occurrence cap (hzm_aln.h:107) falls out naturally: a
    query (read, zmer) group with >= max_per_read occurrences is dropped,
    exactly mirroring the index-side group drop.  The only random gathers
    left are 4 at match width (phase 3).
    """
    from .flatops import expand_ranges

    Q, L = qz.shape
    A = cands_sorted.shape[1]
    assert Q * (1 << (zbits + 1)) < (1 << 31), "key packing overflow: shrink Q or zsize"
    assert expand_budget % RM_BLK == 0, "expand budget must be RM_BLK-aligned"
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    BIGP = jnp.int32(Q * A * 2)
    SENT = INT32_MAX
    ZS = jnp.int32(1 << zbits)

    # ---- phase 1: expand candidate posting slices (block granularity) ----
    c = jnp.clip(cands_sorted, 0, R - 1)
    cvalid = (cands_sorted >= 0) & (cands_sorted < R)
    cstart = jnp.where(cvalid, rm_start[c], 0).reshape(-1)      # aligned
    asz = jnp.where(cvalid, rm_start[c + 1] - rm_start[c], 0).reshape(-1)
    n1 = asz.shape[0]
    NB1 = expand_budget // RM_BLK
    bsrc, bwithin, balive, btot = expand_ranges(asz // RM_BLK, NB1)
    rows = jnp.where(balive, cstart[bsrc] // RM_BLK + bwithin, 0)  # [NB1]
    zsd = rm_zsd.reshape(-1, RM_BLK)[rows].reshape(-1)   # row-gather [MB]
    cpk = rm_pk.reshape(-1, RM_BLK)[rows].reshape(-1)    # row-gather [MB]
    src1c = jnp.broadcast_to(
        bsrc[:, None], (NB1, RM_BLK)).reshape(-1)
    total1 = btot * RM_BLK
    alive1 = jnp.broadcast_to(balive[:, None], (NB1, RM_BLK)).reshape(-1) & (
        (zsd >> 9) < ZS)                                 # gap entries = sentinel
    q1 = src1c // A

    # ---- phase 2: global sort join -----------------------------------
    qpk0 = (
        (qoff.reshape(-1).astype(jnp.int32) << 9)
        | (jnp.minimum(qspan.reshape(-1), 255).astype(jnp.int32) << 1)
        | qdir.reshape(-1).astype(jnp.int32)
    )
    q_of0 = (jnp.arange(Q * L, dtype=jnp.int32) // L).astype(jnp.int32)
    qv0 = qvalid.reshape(-1)
    if qprobe_budget:
        # compact live query zmers to a tight width — padded rows are
        # mostly dead and the join sort pays the full query width
        QK = qprobe_budget
        qdst = jnp.cumsum(qv0.astype(jnp.int32)) - 1
        qdst = jnp.where(qv0, jnp.minimum(qdst, QK), QK)
        qpk = jnp.zeros(QK + 1, jnp.int32).at[qdst].set(qpk0, mode="drop")[:QK]
        q_of = jnp.full(QK + 1, Q, jnp.int32).at[qdst].set(q_of0, mode="drop")[:QK]
        qzc = jnp.zeros(QK + 1, jnp.int32).at[qdst].set(
            qz.reshape(-1).astype(jnp.int32), mode="drop")[:QK]
        qkey = jnp.where(q_of < Q, (q_of << (zbits + 1)) | (qzc << 1), SENT)
        NQ = QK
    else:
        qpk = qpk0
        qkey = jnp.where(
            qv0,
            (q_of0 << (zbits + 1)) | (qz.reshape(-1).astype(jnp.int32) << 1),
            SENT,
        )
        NQ = Q * L
    ckey = jnp.where(
        alive1,
        (q1 << (zbits + 1)) | ((zsd >> 9) << 1) | 1,
        SENT,
    )
    # payloads: query entries carry their packed fields; candidate entries
    # carry pk; aux: candidate (query*A + slot) pair row
    key = jnp.concatenate([qkey, ckey])
    pay = jnp.concatenate([qpk, cpk])
    aux = jnp.concatenate([jnp.zeros(NQ, jnp.int32), src1c])
    key, pay, aux = jax.lax.sort((key, pay, aux), num_keys=1)
    p2 = jnp.arange(pair_budget, dtype=jnp.int32)

    # ---- phase 3: emit n x m co-occurrences --------------------------
    cgs, auxs, bases, alive2, total2 = _emit_runs(
        key, pay, aux, max_per_read=max_per_read, pair_budget=pair_budget)
    # compact query-payload table: the big stream's tag0 entries in
    # (q, zmer) order == the query entries alone, stably sorted by qkey —
    # a SMALL sort replaces the round-3 budget-wide stream scatter
    _, qpayc = jax.lax.sort((qkey, qpk), num_keys=1)
    qg = qpayc[jnp.clip(bases + p2, 0, NQ - 1)]
    qslot2 = jnp.clip(auxs, 0, n1 - 1)
    # candidate read length via two small-table gathers (drops the rm_fo
    # lane from the sort entirely)
    cand2 = jnp.clip(c.reshape(-1)[qslot2], 0, R - 1)
    clen2 = read_lens[cand2].astype(jnp.int32)
    q_span = (qg >> 1) & 0xFF
    p_off = cgs >> 9
    p_span = (cgs >> 1) & 0xFF
    pairdir = (qg ^ cgs) & 1
    o2 = jnp.where(pairdir == 1, clen2 - (p_off + p_span), p_off)
    len_ok = alive2 & (jnp.abs(q_span - p_span) <= kvar)
    pair_id = jnp.where(len_ok, qslot2 * 2 + pairdir, BIGP)
    return PairBatch(
        pair_id=pair_id,
        o1l1=qg >> 1,
        o2l2=(o2 << 8) | p_span,
        match_cnt=jnp.zeros(Q * A * 2, jnp.int32),  # filled by dot_matrix_align
        total=total2,
        expand_total=total1,
    )


@functools.partial(
    jax.jit,
    static_argnames=("expand_budget", "pair_budget", "qm_budget", "kvar",
                     "zbits", "max_per_read"),
)
def extract_zmer_pairs_vtab(
    qrids: jnp.ndarray,   # [Q] int32 global read ids of the batch queries
    cands_sorted: jnp.ndarray,  # [Q, A] int32 candidate read ids (pad INT32_MAX)
    rm_zsd: jnp.ndarray,  # [P] int32 zmer<<9|span<<1|dir, (rd, zmer)-sorted
    rm_pk: jnp.ndarray,   # [P] int32 off<<9|span<<1|dir, same order
    rm_start: jnp.ndarray,  # [R+1] int32 ALIGNED CSR per-read offsets
    read_lens: jnp.ndarray,  # [R] int32
    rm_cnt: jnp.ndarray = None,  # [R] int32 live postings per read
    *,
    expand_budget: int,   # >= total candidate zmer entries this batch
    pair_budget: int,     # >= total matches this batch
    qm_budget: int,       # >= total query zmer entries this batch
    kvar: int = 2,
    zbits: int = 20,      # 2*zsize
    max_per_read: int = 16,
) -> PairBatch:
    """Sort-free per-pair z-mer intersection via a direct-addressed
    (query, zmer) table — the device equivalent of the reference's
    per-read BitVec-with-rank zmer filter (hzm_aln.h:114,152,206).

    The sort-join (`extract_zmer_pairs_join`) pays ~6 sort passes over the
    expanded candidate mass; this version spends exactly 2 gathers per
    expanded element instead:

      1. vt build (query mass, ~1-5%% of expansion): queries are reads, so
         each query's zmer groups are contiguous in the (rd, zmer)-sorted
         index.  Scatter each group's (global start index + 1) << 5 | count
         into vt[(q << zbits) | zmer].
      2. candidate expansion (the hot axis): for every posting of every
         candidate slice, gather its zsd and ONE vt entry; non-matching
         zmers (the vast majority) die right there.
      3. matches expand into the n x m co-occurrence list exactly like the
         join's phase 3, but the query occurrences come straight from the
         vt start index — no sorted run bookkeeping.

    Requires P < 2^25 (index start packs into 25 bits) and zsize <= 12.
    """
    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    assert P < (1 << 25), "vt start packing needs P < 2^25; shard the index (-G)"
    assert max_per_read <= 64, "vt count packing uses 6 bits"
    BIGP = jnp.int32(Q * A * 2)
    VT = Q << zbits

    # ---- phase 1: direct-addressed query zmer table -------------------
    r = jnp.clip(qrids, 0, R - 1)
    qcnt = rm_cnt[r] if rm_cnt is not None else rm_start[r + 1] - rm_start[r]
    from .flatops import expand_ranges

    qsrc, qwithin, qalive, qtotal = expand_ranges(qcnt, qm_budget)
    qidx = jnp.clip(rm_start[r][qsrc] + qwithin, 0, P - 1)
    qzsd = rm_zsd[qidx]
    qzmer = qzsd >> 9
    prev_z = jnp.concatenate([jnp.full((1,), -1, jnp.int32), qzmer[:-1]])
    prev_s = jnp.concatenate([jnp.full((1,), -1, jnp.int32), qsrc[:-1]])
    run_new = qalive & ((qwithin == 0) | (qzmer != prev_z) | (qsrc != prev_s))
    run_id = jnp.cumsum(run_new.astype(jnp.int32)) - 1
    pq = jnp.arange(qm_budget, dtype=jnp.int32)
    # start position (in the expanded axis) of each run; runs are dense ids
    S = (
        jnp.zeros(qm_budget + 1, jnp.int32)
        .at[jnp.where(run_new, run_id, qm_budget)]
        .set(pq, mode="drop")
    )
    n_runs = run_id[-1] + 1
    S = S.at[jnp.clip(n_runs, 0, qm_budget)].set(qtotal, mode="drop")
    run_cnt = S[jnp.clip(run_id + 1, 0, qm_budget)] - pq  # valid at run starts
    vt_idx = jnp.where(
        run_new, (qsrc << zbits) | qzmer, jnp.int32(VT)
    )
    vt_val = ((qidx + 1) << 6) | jnp.minimum(run_cnt, 63)
    vt = jnp.zeros(VT, jnp.int32).at[vt_idx].set(vt_val, mode="drop")

    # ---- phase 2: candidate expansion + table probe -------------------
    c = jnp.clip(cands_sorted, 0, R - 1)
    cvalid = (cands_sorted >= 0) & (cands_sorted < R)
    cstart = jnp.where(cvalid, rm_start[c], 0).reshape(-1)
    clive = rm_cnt[c] if rm_cnt is not None else rm_start[c + 1] - rm_start[c]
    cnt1 = jnp.where(cvalid, clive, 0).reshape(-1)
    clen_flat = jnp.where(cvalid, read_lens[c], 0).reshape(-1)  # [Q*A]
    src1, within1, alive1, total1 = expand_ranges(cnt1, expand_budget)
    pidx = jnp.clip(cstart[src1] + within1, 0, P - 1)
    zsd = jnp.where(alive1, rm_zsd[pidx], 0)                 # gather 1 [MB]
    q1 = src1 // A
    probe = jnp.where(
        alive1, (q1 << zbits) | (zsd >> 9), jnp.int32(VT)
    )
    qinfo = jnp.concatenate([vt, jnp.zeros(1, jnp.int32)])[
        jnp.minimum(probe, VT)
    ]                                                        # gather 2 [MB]
    qstart1 = (qinfo >> 6) - 1
    cnt2 = jnp.where(alive1 & (qinfo != 0), qinfo & 63, 0)

    # ---- phase 3: emit n x m co-occurrences ---------------------------
    src2, within2, alive2, total2 = expand_ranges(cnt2, pair_budget)
    pidx2 = jnp.clip(pidx[src2], 0, P - 1)                   # gather 3 [PB]
    qslot2 = jnp.clip(src1[src2], 0, Q * A - 1)              # gather 4 [PB]
    qidx2 = jnp.clip(qstart1[src2] + within2, 0, P - 1)      # gather 5 [PB]
    qg = rm_pk[qidx2]                                        # gather 6 [PB]
    cg = rm_pk[pidx2]                                        # gather 7 [PB]
    cln = clen_flat[qslot2]                                  # gather 8 [PB]
    q_span = (qg >> 1) & 0xFF
    p_off = cg >> 9
    p_span = (cg >> 1) & 0xFF
    pairdir = (qg ^ cg) & 1
    o2 = jnp.where(pairdir == 1, cln - (p_off + p_span), p_off)
    len_ok = alive2 & (jnp.abs(q_span - p_span) <= kvar)
    pair_id = jnp.where(len_ok, qslot2 * 2 + pairdir, BIGP)
    return PairBatch(
        pair_id=pair_id,
        o1l1=qg >> 1,
        o2l2=(o2 << 8) | p_span,
        match_cnt=jnp.zeros(Q * A * 2, jnp.int32),  # filled by dot_matrix_align
        total=total2,
        expand_total=total1,
    )


def extract_zmer_pairs_sweep(
    qrids: jnp.ndarray,   # [Q] int32 global read ids of the batch queries
    qskip: jnp.ndarray,   # [Q] bool padded/dead query rows
    cands_sorted: jnp.ndarray,  # [Q, A] int32 candidate read ids (pad INT32_MAX)
    rm_zsd: jnp.ndarray,  # [P] int32 zmer<<9|span<<1|dir, (rd, zmer)-sorted
    rm_pk: jnp.ndarray,   # [P] int32 off<<9|span<<1|dir, same order
    rm_rd: jnp.ndarray,   # [P] int32 read id per posting
    rm_start: jnp.ndarray,  # [R+1] int32 ALIGNED CSR per-read offsets
    read_lens: jnp.ndarray,  # [R] int32
    rm_cnt: jnp.ndarray = None,  # [R] int32 live postings per read (aligned
                                 # layout; None = compact layout, CSR diffs)
    *,
    cross_budget: int,    # >= sum over batch query postings of global freq
    occ_budget: int,      # >= total query zmer postings this batch
    kvar: int = 2,
    zbits: int = 20,      # 2*zsize
    pair_budget: int | None = None,   # compact matches to this width
) -> PairBatch:
    """Index-sweep z-mer matcher: iterate the WHOLE posting index once per
    batch (sequentially) and probe a per-batch zmer -> query-occurrence
    table.

    Rationale (the candidate-side vtab matcher is bound by 2 random
    gathers per element into ~20-60 MB arrays):
      - candidate-side expansion repeats each read's postings once per
        query it is candidate of (~Q*A/R times per batch); sweeping the
        index visits each posting once per batch — ~5x less mass at Q=64;
      - the sweep side reads rm_* arrays in order (monotone gathers);
      - the random probes hit small tables (the 4 MB zmer-start table,
        the batch occurrence list, the [Q, R] slot table) instead of the
        20-60 MB posting/vt arrays.
    Semantics match the reference per-pair n x m zmer co-occurrence with
    span tolerance (hzm_aln.h:114-240): every (query occurrence,
    candidate posting) pair of a shared zmer is emitted.
    """
    from .flatops import expand_ranges

    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    BIGP = jnp.int32(Q * A * 2)
    ZS = 1 << zbits

    # ---- slot table: (q, rd) -> candidate slot + 1 ---------------------
    qi = jnp.arange(Q, dtype=jnp.int32)[:, None]
    slot_i = jnp.arange(A, dtype=jnp.int32)[None, :]
    cok = (cands_sorted >= 0) & (cands_sorted < R) & ~qskip[:, None]
    slot_table = jnp.zeros((Q, R + 1), jnp.int8).at[
        jnp.where(cok, qi, Q - 1).reshape(-1),
        jnp.where(cok, jnp.clip(cands_sorted, 0, R - 1), R).reshape(-1),
    ].set(jnp.broadcast_to((slot_i + 1).astype(jnp.int8), (Q, A)).reshape(-1),
          mode="drop")

    # ---- batch query occurrence table, zmer-sorted ---------------------
    r = jnp.clip(qrids, 0, R - 1)
    qlive = rm_cnt[r] if rm_cnt is not None else rm_start[r + 1] - rm_start[r]
    qcnt = jnp.where(qskip, 0, qlive)
    qsrc, qwithin, qalive, qtotal = expand_ranges(qcnt, occ_budget)
    qidx = jnp.clip(rm_start[r][qsrc] + qwithin, 0, P - 1)
    qz = jnp.where(qalive, rm_zsd[qidx] >> 9, jnp.int32(ZS))
    qpk0 = jnp.where(qalive, rm_pk[qidx], 0)
    qz, occ_q, occ_pk = jax.lax.sort(
        (qz, jnp.where(qalive, qsrc, Q), qpk0), num_keys=1)
    bq_cnt = jnp.zeros(ZS + 1, jnp.int32).at[jnp.minimum(qz, ZS)].add(
        1, mode="drop")[:ZS]
    bq_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(bq_cnt).astype(jnp.int32)])

    # ---- sweep: expand (posting x query occurrence) --------------------
    return _sweep_emit(qrids, cands_sorted, slot_table,
                       rm_zsd, rm_pk, rm_rd, rm_start, read_lens,
                       bq_cnt, bq_start, occ_q, occ_pk, qtotal,
                       cross_budget=cross_budget, kvar=kvar, zbits=zbits,
                       pair_budget=pair_budget)


def build_query_occ_rows(qz_rows, qpk_rows, qvalid, *, occ_budget: int,
                         zbits: int, max_per_read: int):
    """Zmer-sorted occurrence table from [Q, L] query seed rows.

    Used by the sharded driver, where the query's postings may live on a
    different index shard: occurrences come from the batch's own seed
    extraction.  Applies the per-(read, zmer) frequency cap exactly like
    the index build (hzm_aln.h:107) so sharded matching equals the
    single-chip sweep.
    """
    Q, L = qz_rows.shape
    ZS = 1 << zbits
    qf = jnp.where(qvalid, qz_rows.astype(jnp.int32), jnp.int32(ZS)).reshape(-1)
    qq = jnp.broadcast_to(jnp.arange(Q, dtype=jnp.int32)[:, None],
                          (Q, L)).reshape(-1)
    pk = qpk_rows.reshape(-1)
    # sort by (q, zmer) to apply the per-(q, zmer) cap on runs
    key = jnp.where(qf < ZS, qq * (ZS + 1) + qf, Q * (ZS + 1) + ZS)
    key, qf2, qq2, pk2 = jax.lax.sort((key, qf, qq, pk), num_keys=1)
    new = jnp.concatenate([jnp.ones(1, bool), key[1:] != key[:-1]])
    gid = jnp.cumsum(new.astype(jnp.int32)) - 1
    gcnt = jax.ops.segment_sum(
        (qf2 < ZS).astype(jnp.int32), jnp.where(qf2 < ZS, gid, Q * L),
        num_segments=Q * L + 1)[: Q * L]
    keep = (qf2 < ZS) & (gcnt[jnp.clip(gid, 0, Q * L - 1)] < max_per_read)
    qf3 = jnp.where(keep, qf2, ZS)
    # re-sort by zmer alone for the occurrence table
    qz, occ_q, occ_pk = jax.lax.sort(
        (qf3, jnp.where(keep, qq2, Q), pk2), num_keys=1)
    qtotal = jnp.sum(keep.astype(jnp.int32))
    bq_cnt = jnp.zeros(ZS + 1, jnp.int32).at[jnp.minimum(qz, ZS)].add(
        1, mode="drop")[:ZS]
    bq_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(bq_cnt).astype(jnp.int32)])
    # clip the table to occ_budget width (callers size it to fit)
    return (bq_cnt, bq_start, occ_q[:occ_budget], occ_pk[:occ_budget], qtotal)


def extract_zmer_pairs_sweep_rows(
    qrids, cands_sorted, occ_tables,
    rm_zsd, rm_pk, rm_rd, rm_start, read_lens,
    *, cross_budget: int, kvar: int = 2, zbits: int = 20,
    pair_budget: int | None = None,
) -> PairBatch:
    """Sweep matcher with a precomputed occurrence table (sharded path)."""
    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    bq_cnt, bq_start, occ_q, occ_pk, qtotal = occ_tables
    qi = jnp.arange(Q, dtype=jnp.int32)[:, None]
    slot_i = jnp.arange(A, dtype=jnp.int32)[None, :]
    cok = (cands_sorted >= 0) & (cands_sorted < R)
    slot_table = jnp.zeros((Q, R + 1), jnp.int8).at[
        jnp.where(cok, qi, Q - 1).reshape(-1),
        jnp.where(cok, jnp.clip(cands_sorted, 0, R - 1), R).reshape(-1),
    ].set(jnp.broadcast_to((slot_i + 1).astype(jnp.int8), (Q, A)).reshape(-1),
          mode="drop")
    return _sweep_emit(qrids, cands_sorted, slot_table,
                       rm_zsd, rm_pk, rm_rd, rm_start, read_lens,
                       bq_cnt, bq_start, occ_q, occ_pk, qtotal,
                       cross_budget=cross_budget, kvar=kvar, zbits=zbits,
                       pair_budget=pair_budget)


def _sweep_emit(qrids, cands_sorted, slot_table, rm_zsd, rm_pk, rm_rd,
                rm_start, read_lens, bq_cnt, bq_start, occ_q, occ_pk, qtotal,
                *, cross_budget: int, kvar: int, zbits: int,
                pair_budget: int | None = None):
    from .flatops import expand_ranges

    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    BIGP = jnp.int32(Q * A * 2)
    ZS = 1 << zbits
    occ_budget = occ_q.shape[0]
    live_p = jnp.arange(P, dtype=jnp.int32) < rm_start[jnp.minimum(
        R, rm_start.shape[0] - 1)]
    # aligned-layout gap entries carry sentinel zsd (zmer == ZS): mask them
    z_p = jnp.where(live_p, rm_zsd >> 9, ZS)
    cnt_p = jnp.where(z_p < ZS, bq_cnt[jnp.clip(z_p, 0, ZS - 1)], 0)
    src, within, alive, total = expand_ranges(cnt_p, cross_budget)
    src_c = jnp.clip(src, 0, P - 1)
    z_e = z_p[src_c]                                   # monotone gather
    cpk = rm_pk[src_c]                                 # monotone gather
    rd_e = rm_rd[src_c]                                # monotone gather
    occ_idx = jnp.clip(bq_start[jnp.clip(z_e, 0, ZS - 1)] + within,
                       0, occ_budget - 1)
    q_e = occ_q[occ_idx]                               # small-table gather
    qpk = occ_pk[occ_idx]                              # small-table gather
    q_ec = jnp.clip(q_e, 0, Q - 1)
    slot = slot_table[q_ec, jnp.clip(rd_e, 0, R)].astype(jnp.int32) - 1
    q_span = (qpk >> 1) & 0xFF
    p_span = (cpk >> 1) & 0xFF
    ok = (
        alive & (q_e < Q) & (slot >= 0)
        & (rd_e != qrids[q_ec])
        & (jnp.abs(q_span - p_span) <= kvar)
    )
    pairdir = (qpk ^ cpk) & 1
    cln = read_lens[jnp.clip(rd_e, 0, R - 1)]
    p_off = cpk >> 9
    o2 = jnp.where(pairdir == 1, cln - (p_off + p_span), p_off)
    pair_id = jnp.where(ok, (q_ec * A + slot) * 2 + pairdir, BIGP)
    if pair_budget is None or pair_budget >= cross_budget:
        return PairBatch(
            pair_id=pair_id, o1l1=qpk >> 1, o2l2=(o2 << 8) | p_span,
            match_cnt=jnp.zeros(Q * A * 2, jnp.int32),
            total=total, expand_total=total,
        )
    # compact survivors (~10-25% of the cross mass) so the dot-matrix
    # block phases sort/scan at match width instead of cross width
    dst = jnp.cumsum(ok.astype(jnp.int32)) - 1
    n_match = dst[-1] + 1
    dsti = jnp.where(ok, jnp.minimum(dst, pair_budget), pair_budget)

    def comp(v, fill):
        return (jnp.full(pair_budget + 1, fill, jnp.int32)
                .at[dsti].set(v.astype(jnp.int32), mode="drop")[:pair_budget])

    return PairBatch(
        pair_id=comp(pair_id, Q * A * 2),
        o1l1=comp(qpk >> 1, 0),
        o2l2=comp((o2 << 8) | p_span, 0),
        match_cnt=jnp.zeros(Q * A * 2, jnp.int32),
        total=n_match,
        # the sweep's expansion axis is the cross product; reporting it
        # (not the occurrence count, which is exact by construction) lets
        # the caller detect cross-budget overflow and redispatch
        expand_total=total,
    )


# ---------------------------------------------------------------------------
# phases 3-5: blocks, merge, chain
# ---------------------------------------------------------------------------


class DotMatrixResult(NamedTuple):
    match_cnt: jnp.ndarray  # [Q*A*2] int32 seed matches per pair id
    blk_total: jnp.ndarray  # scalar int32: blocks formed (vs nbk budget)
    row_total: jnp.ndarray  # scalar int32: live pair rows (vs pd budget)
    pair_id: jnp.ndarray  # [PD] int32 (BIGP pad); PD = pd or n_pairs
    score: jnp.ndarray    # [PD] int32 chained coverage weight
    tb: jnp.ndarray       # [PD] int32 query begin
    te: jnp.ndarray       # [PD] int32 query end
    qb: jnp.ndarray       # [PD] int32 candidate begin
    qe: jnp.ndarray       # [PD] int32 candidate end
    # chained window blocks (anchor regions) per pair, beg0-sorted:
    blk_b0: jnp.ndarray   # [PD, NB] int32 query-axis begin
    blk_e0: jnp.ndarray   # [PD, NB] int32 query-axis end
    blk_b1: jnp.ndarray   # [PD, NB] int32 candidate-axis begin
    blk_e1: jnp.ndarray   # [PD, NB] int32 candidate-axis end
    blk_on: jnp.ndarray   # [PD, NB] bool  True if the block is on the chain


def _seg_firsts(valid_first, seg_id, vals, n_seg, fill):
    idx = jnp.where(valid_first, seg_id, n_seg)
    return (
        jnp.full(n_seg + 1, fill, jnp.int32).at[idx].set(vals.astype(jnp.int32), mode="drop")[:n_seg]
    )


@functools.partial(
    jax.jit,
    static_argnames=("n_pairs", "nb", "xvar", "yvar", "min_block_len", "max_overhang",
                     "nbk", "pd", "max_len"),
)
def dot_matrix_align(
    pairs: PairBatch,
    qlens_of_pair: jnp.ndarray,  # [Q*A*2] int32 query length per pair id
    clens_of_pair: jnp.ndarray,  # [Q*A*2] int32 candidate length per pair id
    *,
    n_pairs: int,      # dense pair rows for the chain DP
    nb: int = 32,      # max blocks chained per pair
    xvar: int = 128,
    yvar: int = 64,
    min_block_len: int = 160,
    max_overhang: int = 256,
    deviation_penalty: float = 1.0,
    gap_penalty: float = 0.05,
    nbk: int | None = None,  # block budget: merge phase runs at this width
                             # (blocks are ~10-50x fewer than matches; the
                             # caller redispatches if blk_total overflows)
    pd: int | None = None,   # dense pair-row budget: the chain DP and the
                             # [rows, nb] window tables run at this width
                             # (live pairs are ~2 x live candidates, a few
                             # percent of Q*A*2; caller redispatches if
                             # row_total overflows)
    max_len: int = 1 << 17,  # static read-length bound (sets the packed
                             # sort key's diagonal-bucket range)
) -> DotMatrixResult:
    """Diagonal grouping redesign (round 4): ONE packed 3-lane sort
    replaces the round-3 two 6-lane sorts.  Matches sort by
    (pair, diag // yvar, off1) — fixed yvar-wide diagonal buckets instead
    of adaptive diagonal runs (the reference uses overlapping yvar windows
    + union-find, hzm_aln.h:721-889; both groupings are yvar-scale).
    Sub-threshold blocks are dropped BEFORE the merge exactly like the
    reference (noise blocks otherwise chain into spurious windows), with
    one bucket-split recovery: a half-threshold block whose neighbor
    block continues it across the bucket boundary survives."""
    PB = pairs.pair_id.shape[0]
    if nbk is None:
        nbk = PB
    BIGP = qlens_of_pair.shape[0]  # == Q*A*2
    diag = (pairs.o1l1 >> 8) - (pairs.o2l2 >> 8)
    dead = pairs.pair_id >= BIGP
    # NDQ = pow2 diagonal-bucket range so pid unpacks as a shift
    ndq_need = 2 * (max_len // max(yvar, 1)) + 4
    NDQ = 1 << (ndq_need - 1).bit_length()
    HALF = NDQ // 2
    dq = jnp.clip(diag // yvar + HALF, 0, NDQ - 1)
    o1l1 = pairs.o1l1
    o2l2 = pairs.o2l2
    assert (n_pairs + 1) * NDQ < (1 << 31) - 1, (
        "pair/diag key packing overflow: lower batch_q*ncand or max_len")
    kq = jnp.where(dead, INT32_MAX, pairs.pair_id * NDQ + dq)
    kq, ko, o2l2s = jax.lax.sort(
        (kq, jnp.where(dead, INT32_MAX, o1l1), o2l2), num_keys=2)
    live = kq != INT32_MAX
    pid = jnp.where(live, kq >> int(NDQ - 1).bit_length(), jnp.int32(BIGP))
    o1 = jnp.where(live, ko >> 8, 0)
    l1 = jnp.where(live, ko & 255, 0)
    o2 = o2l2s >> 8
    l2 = o2l2s & 255
    grp_change = jnp.concatenate([jnp.ones(1, bool), kq[1:] != kq[:-1]])
    prev_end1 = jnp.concatenate([jnp.zeros(1, jnp.int32), (o1 + l1)[:-1]])
    # only live elements open blocks — dead (padded) elements must not
    # inflate the block count past the compact budget
    blk_new = live & (grp_change | (o1 > prev_end1 + xvar))
    contrib = jnp.where(blk_new, l1, (o1 + l1) - prev_end1)
    contrib = jnp.where(live, contrib, 0)
    nseg = nbk
    blk_id = jnp.maximum(jnp.cumsum(blk_new.astype(jnp.int32)) - 1, 0)
    blk_total = blk_id[-1] + 1
    # block ids are dense-sequential, so reductions land directly in
    # the compact [nbk] block space and the whole merge phase runs
    # ~PB/nbk x narrower; out-of-budget ids drop (caller checks
    # blk_total)
    b_w = jax.ops.segment_sum(contrib, blk_id, num_segments=nseg, indices_are_sorted=True)
    b_beg0 = jax.ops.segment_min(jnp.where(live, o1, INT32_MAX), blk_id, num_segments=nseg, indices_are_sorted=True)
    b_end0 = jax.ops.segment_max(jnp.where(live, o1 + l1, 0), blk_id, num_segments=nseg, indices_are_sorted=True)
    b_beg1 = jax.ops.segment_min(jnp.where(live, o2, INT32_MAX), blk_id, num_segments=nseg, indices_are_sorted=True)
    b_end1 = jax.ops.segment_max(jnp.where(live, o2 + l2, 0), blk_id, num_segments=nseg, indices_are_sorted=True)
    b_pid = _seg_firsts(blk_new & live, blk_id, pid, nseg, int(BIGP))
    b_cnt = jax.ops.segment_sum(live.astype(jnp.int32), blk_id,
                                num_segments=nseg, indices_are_sorted=True)
    # per-pair seed-match counts: every live match belongs to exactly one
    # block, so match_cnt = scatter-add of block counts at nbk width (the
    # round-3 design paid a second full-width pass for this)
    match_cnt = (
        jnp.zeros(int(BIGP) + 1, jnp.int32)
        .at[jnp.minimum(b_pid, jnp.int32(BIGP))]
        .add(b_cnt, mode="drop")[: int(BIGP)]
    )
    # the min_block_len gate MUST precede the merge (reference
    # hzm_aln.h:833-846): sub-threshold noise blocks otherwise chain into
    # large spurious windows via single-linkage on dense random matches
    # (measured: chain scores inflate ~+1000 and extents overrun the true
    # overlap).  A fixed-bucket boundary can split one true block into
    # two sub-threshold halves, so blocks above half the threshold also
    # survive IF the adjacent bucket continues them (end/start within
    # xvar on the query axis) — recovering exactly the boundary splits
    # without admitting isolated noise.
    b_half = (b_pid < BIGP) & (b_w >= (min_block_len + 1) // 2)
    nxt_pid = jnp.concatenate([b_pid[1:], jnp.full(1, BIGP, jnp.int32)])
    nxt_b0 = jnp.concatenate([b_beg0[1:], jnp.zeros(1, jnp.int32)])
    nxt_half = jnp.concatenate([b_half[1:], jnp.zeros(1, bool)])
    prv_pid = jnp.concatenate([jnp.full(1, BIGP, jnp.int32), b_pid[:-1]])
    prv_e0 = jnp.concatenate([jnp.zeros(1, jnp.int32), b_end0[:-1]])
    prv_half = jnp.concatenate([jnp.zeros(1, bool), b_half[:-1]])
    join_nxt = nxt_half & (nxt_pid == b_pid) & (nxt_b0 <= b_end0 + xvar)
    join_prv = prv_half & (prv_pid == b_pid) & (b_beg0 <= prv_e0 + xvar)
    b_live = (b_pid < BIGP) & (
        (b_w >= min_block_len) | (b_half & (join_nxt | join_prv)))
    # ---- fast merge: single-linkage over blocks at (xvar, 2*yvar) scale ----
    # Surviving blocks are a small fraction of the block budget (the
    # min_block_len gate kills most noise blocks), so the merge + window
    # phases run at the narrower NBL budget: the first sort doubles as the
    # compactor (live blocks sort to the front), everything after slices
    # its prefix.  If live blocks ever exceed NBL, blk_total reports past
    # the nbk budget so the caller's overflow redispatch regrows both.
    NBL = max(nbk // 8, 1 << 14)
    live_total = jnp.sum(b_live.astype(jnp.int32))
    m1 = jnp.where(b_live, b_pid, jnp.int32(BIGP))
    m2 = jnp.where(b_live, b_beg0 - b_beg1, INT32_MAX)
    m3 = jnp.where(b_live, b_beg0, INT32_MAX)
    m1, m2, m3, me0, mb1, me1, mw = jax.lax.sort(
        (m1, m2, m3, b_end0, b_beg1, b_end1, b_w), num_keys=3
    )
    m1, m2, m3 = m1[:NBL], m2[:NBL], m3[:NBL]
    me0, mb1, me1, mw = me0[:NBL], mb1[:NBL], me1[:NBL], mw[:NBL]
    nseg = NBL
    mlive = m1 < BIGP
    mp_new = jnp.concatenate([jnp.ones(1, bool), m1[1:] != m1[:-1]])
    mg_new = mp_new | jnp.concatenate(
        [jnp.ones(1, bool), (m2[1:] - m2[:-1]) > 2 * yvar]
    )
    mg_id = jnp.cumsum(mg_new.astype(jnp.int32)) - 1
    h1 = jnp.where(mlive, mg_id, INT32_MAX)
    h1, hb0, he0, hb1, he1, hw, hpid = jax.lax.sort(
        (h1, m3, me0, mb1, me1, mw, m1), num_keys=2
    )
    hlive = h1 < INT32_MAX
    prev_he0 = jnp.concatenate([jnp.zeros(1, jnp.int32), he0[:-1]])
    w_new = hlive & (
        jnp.concatenate([jnp.ones(1, bool), h1[1:] != h1[:-1]])
        | (hb0 > prev_he0 + xvar)
    )
    w_id = jnp.maximum(jnp.cumsum(w_new.astype(jnp.int32)) - 1, 0)
    W_w = jax.ops.segment_sum(jnp.where(hlive, hw, 0), w_id, num_segments=nseg, indices_are_sorted=True)
    W_b0 = jax.ops.segment_min(jnp.where(hlive, hb0, INT32_MAX), w_id, num_segments=nseg, indices_are_sorted=True)
    W_e0 = jax.ops.segment_max(jnp.where(hlive, he0, 0), w_id, num_segments=nseg, indices_are_sorted=True)
    W_b1 = jax.ops.segment_min(jnp.where(hlive, hb1, INT32_MAX), w_id, num_segments=nseg, indices_are_sorted=True)
    W_e1 = jax.ops.segment_max(jnp.where(hlive, he1, 0), w_id, num_segments=nseg, indices_are_sorted=True)
    W_pid = _seg_firsts(w_new & hlive, w_id, hpid, nseg, int(BIGP))
    # min_block_len applies to MERGED windows: fixed diagonal buckets can
    # split one true anchor region into two sub-threshold blocks, and the
    # 2*yvar merge rejoins them before the filter (reference min_block_len
    # gating hzm_aln.h:833-846 precedes its merge, but its diagonal
    # windows overlap, which prevents boundary splits in the first place)
    W_live = (W_pid < BIGP) & (W_w >= min_block_len)
    # ---- gather top-nb windows per pair into dense [pd, nb] ----
    # live rows pack at the front (row_of is a dense rank), so the chain
    # DP runs at the pd budget instead of the full Q*A*2 row space
    if pd is None:
        pd = n_pairs
    s1 = jnp.where(W_live, W_pid, jnp.int32(BIGP))
    s2 = jnp.where(W_live, INT32_MAX - W_w, INT32_MAX)
    s1, s2, sb0, se0, sb1, se1 = jax.lax.sort(
        (s1, s2, W_b0, W_e0, W_b1, W_e1), num_keys=2
    )
    sw = jnp.where(s1 < BIGP, INT32_MAX - s2, 0)
    srow_new = jnp.concatenate([jnp.ones(1, bool), s1[1:] != s1[:-1]]) & (s1 < BIGP)
    row_of = jnp.cumsum(srow_new.astype(jnp.int32)) - 1  # dense row index
    row_total = row_of[-1] + 1
    pos = jnp.arange(nseg, dtype=jnp.int32)
    row_first = jnp.full(pd + 1, 0, jnp.int32).at[
        jnp.where(srow_new & (row_of < pd), row_of, pd)
    ].set(pos, mode="drop")[:pd]
    col = pos - row_first[jnp.clip(row_of, 0, pd - 1)]
    ok = (s1 < BIGP) & (col < nb) & (row_of < pd)
    r = jnp.where(ok, row_of, pd)
    c = jnp.where(ok, col, 0)
    def dense(vals, fill):
        return (
            jnp.full((pd + 1, nb), fill, jnp.int32)
            .at[r, c]
            .set(vals, mode="drop")[:pd]
        )
    D_b0 = dense(sb0, int(INT32_MAX))
    D_e0 = dense(se0, 0)
    D_b1 = dense(sb1, int(INT32_MAX))
    D_e1 = dense(se1, 0)
    D_w = dense(sw, 0)
    D_pid = (
        jnp.full(pd + 1, int(BIGP), jnp.int32)
        .at[jnp.where(srow_new & (row_of < pd), row_of, pd)]
        .set(s1, mode="drop")[:pd]
    )
    D_valid = D_w > 0
    # re-sort each row by beg0 for the chain DP
    key = jnp.where(D_valid, D_b0, INT32_MAX)
    key, D_e0, D_b1, D_e1, D_w, D_b0 = jax.lax.sort(
        (key, D_e0, D_b1, D_e1, D_w, D_b0), num_keys=1
    )
    D_valid = key < INT32_MAX
    # ---- chain DP (hzm_aln.h:1056-1132) ----
    qlen = qlens_of_pair[jnp.clip(D_pid, 0, BIGP - 1)]
    clen = clens_of_pair[jnp.clip(D_pid, 0, BIGP - 1)]
    tail_margin = xvar
    head = (
        (D_b0 <= tail_margin) | (D_b1 <= tail_margin)
    ).astype(jnp.int32)
    tail = (
        (D_e0 + tail_margin > qlen[:, None]) | (D_e1 + tail_margin > clen[:, None])
    ).astype(jnp.int32)
    head = jnp.where(D_valid, head, 0)
    tail = jnp.where(D_valid, tail, 0)
    colix = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32)[None, :], D_w.shape)

    def step(state, i):
        weight, hd, bt, mw, btg = state
        wi = jnp.take_along_axis(weight, i[:, None], axis=1)[:, 0] + jnp.take_along_axis(
            D_w, i[:, None], axis=1
        )[:, 0]
        hi = jnp.take_along_axis(hd, i[:, None], axis=1)[:, 0]
        ti = jnp.take_along_axis(tail, i[:, None], axis=1)[:, 0]
        vi = jnp.take_along_axis(D_valid, i[:, None], axis=1)[:, 0]
        e0 = jnp.take_along_axis(D_e0, i[:, None], axis=1)[:, 0]
        e1 = jnp.take_along_axis(D_e1, i[:, None], axis=1)[:, 0]
        cand_total = (wi * ((hi + 3) * (ti + 3))) // 16
        better = vi & (cand_total > mw)
        mw = jnp.where(better, cand_total, mw)
        btg = jnp.where(better, i, btg)
        Wlim = (wi.astype(jnp.float32) / gap_penalty).astype(jnp.int32)
        d0 = D_b0 - e0[:, None]
        d1 = D_b1 - e1[:, None]
        allowed = (
            (colix > i[:, None])
            & D_valid
            & vi[:, None]
            & (D_b0 + max_overhang >= e0[:, None])
            & (D_b1 + max_overhang >= e1[:, None])
            & (d0 <= Wlim[:, None])
        )
        band = jnp.abs(d0 - d1)
        gap = jnp.abs(jnp.maximum(d0, d1))
        pen = (
            band.astype(jnp.float32) * deviation_penalty
            + gap.astype(jnp.float32) * gap_penalty
        ).astype(jnp.int32)
        score = wi[:, None] - pen
        upd = allowed & (weight <= score)
        weight = jnp.where(upd, score, weight)
        bt = jnp.where(upd, i[:, None], bt)
        hd = jnp.where(upd, hi[:, None], hd)
        # store wi back at column i
        onehot = colix == i[:, None]
        weight = jnp.where(onehot, wi[:, None], weight)
        return (weight, hd, bt, mw, btg), None

    NP = D_w.shape[0]
    init = (
        jnp.zeros((NP, nb), jnp.int32),
        head,
        jnp.full((NP, nb), -1, jnp.int32),
        jnp.full(NP, NEG_BIG, jnp.int32),
        jnp.full(NP, -1, jnp.int32),
    )
    iters = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32)[:, None], (nb, NP))
    (weight, hd, bt, mw, btg), _ = jax.lax.scan(step, init, iters)
    # traceback: follow bt pointers from btg, marking chain membership
    mark = jnp.zeros((NP, nb), bool)
    cur = btg

    def tb_step(state, _):
        mark, cur = state
        ok = cur >= 0
        curc = jnp.clip(cur, 0, nb - 1)
        mark = mark.at[jnp.arange(NP), curc].set(
            mark[jnp.arange(NP), curc] | ok
        )
        nxt = bt[jnp.arange(NP), curc]
        cur = jnp.where(ok, nxt, -1)
        return (mark, cur), None

    (mark, _), _ = jax.lax.scan(tb_step, (mark, cur), None, length=nb)
    mark = mark & D_valid
    score = jnp.sum(jnp.where(mark, D_w, 0), axis=1)
    tb_ = jnp.min(jnp.where(mark, D_b0, INT32_MAX), axis=1)
    te_ = jnp.max(jnp.where(mark, D_e0, 0), axis=1)
    qb_ = jnp.min(jnp.where(mark, D_b1, INT32_MAX), axis=1)
    qe_ = jnp.max(jnp.where(mark, D_e1, 0), axis=1)
    # live blocks overflowing the NBL merge budget report past nbk so the
    # caller's redispatch regrows nbk (and with it NBL = nbk/8); when
    # NBL == nbk nothing was truncated and the existing blk_total-vs-nbk
    # check already covers the budget edge
    if NBL < nbk:
        # report the REAL requirement (8x the live mass + slack) so one
        # redispatch sizes nbk correctly instead of doubling per attempt
        blk_total = jnp.where(
            live_total > NBL,
            jnp.maximum(blk_total, 8 * (live_total + 2048)),
            blk_total)
    return DotMatrixResult(
        match_cnt=match_cnt,
        blk_total=blk_total,
        row_total=row_total,
        pair_id=D_pid, score=score, tb=tb_, te=te_, qb=qb_, qe=qe_,
        blk_b0=D_b0, blk_e0=D_e0, blk_b1=D_b1, blk_e1=D_e1, blk_on=mark,
    )
