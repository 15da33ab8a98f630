"""Candidate selection — batched device kernel.

Batched device replacement for the k-way heap-merge candidate scan
`query_wtzmo` (reference wtzmo.c:433-573).  Instead of merging posting
lists with a heap per read, a whole batch of query reads is processed at
once: posting ranges come from vectorised binary search into the sorted
index, a fixed-budget expansion materialises (query, candidate) seed
events, and a sort + segmented scan computes the same non-overlapping
covered-length score ("ol") per (query, candidate, dir).  Top-A selection
(wtzmo.c:500-571 candidate min-heap) becomes a sort + rank mask.

Reference filter semantics preserved:
  - candidates longer than 1.2x the query are skipped (wtzmo.c:489)
  - per (candidate,dir) ol accumulates non-overlapping query coverage
    (wtzmo.c:559-563), dirs merged by max (x1/x2 logic :525-535)
  - candidates need ol >= kovl (:525)
  - an explicit suppression list replaces the closed_alns ledger
    (wtzmo.c:813-820): pairs already attempted by an earlier query
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

INT32_MAX = jnp.int32(0x7FFFFFFF)


def _binary_search_rows(table: jnp.ndarray, row_ids: jnp.ndarray, values: jnp.ndarray,
                        row_cnt: jnp.ndarray) -> jnp.ndarray:
    """Membership test of values in per-row sorted arrays via manual bisect.

    table: [Q, S] sorted int32 rows (padded with INT32_MAX)
    row_ids/values: [N] — for each element, the row and the probe value.
    Returns bool [N]: value present in table[row, :row_cnt[row]].
    """
    S = table.shape[1]
    if S == 0:
        return jnp.zeros(values.shape, bool)
    steps = max(1, (S - 1).bit_length())
    lo = jnp.zeros(values.shape, jnp.int32)
    hi = jnp.minimum(row_cnt[row_ids], S).astype(jnp.int32)
    for _ in range(steps + 1):
        mid = (lo + hi) >> 1
        mv = table[row_ids, jnp.clip(mid, 0, S - 1)]
        go_right = (mv < values) & (mid < hi)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, jnp.where(mid < hi, mid, hi))
    found = table[row_ids, jnp.clip(lo, 0, S - 1)] == values
    return found & (lo < jnp.minimum(row_cnt[row_ids], S))


@functools.partial(
    jax.jit, static_argnames=("budget", "ncand", "kovl", "len_ratio",
                              "probe_budget")
)
def scan_candidates(
    qkmer: jnp.ndarray,   # [Q, L] uint32 canonical kmers (compressed-pos space)
    qoff: jnp.ndarray,    # [Q, L] int32 raw offsets
    qspan: jnp.ndarray,   # [Q, L] int32 raw spans
    qvalid: jnp.ndarray,  # [Q, L] bool
    qrids: jnp.ndarray,   # [Q] int32 global read ids of queries
    qlens: jnp.ndarray,   # [Q] int32 query lengths
    qskip: jnp.ndarray,   # [Q] bool — skip whole read (nbest early stop)
    idx_kmers: jnp.ndarray,  # [P] uint32 sorted
    post_rd: jnp.ndarray,    # [P] int32
    post_dir: jnp.ndarray,   # [P] int8 occurrence strand
    read_lens: jnp.ndarray,  # [R] int32 lengths of all reads
    suppress: jnp.ndarray,   # [Q, S] int32 sorted candidate ids to suppress
    suppress_cnt: jnp.ndarray,  # [Q] int32
    *,
    budget: int,
    ncand: int,
    kovl: int,
    len_ratio: float = 1.2,
    probe_budget: int = 0,   # 0 = no probe compaction (Q*L probes)
):
    """Returns (cands [Q, ncand] int32 (-1 pad, ol-desc order), ols [Q, ncand],
    total expansion, total probes)."""
    Q, L = qkmer.shape
    q_row = (jnp.arange(Q * L, dtype=jnp.int32) // L).astype(jnp.int32)
    # skipped queries (nbest early stop / batch padding) must not consume
    # expansion budget — the budget is sized from live queries only
    pvalid = qvalid.reshape(-1) & ~qskip[q_row]
    if probe_budget:
        # compact live probes to a tight width before the index search —
        # padded [Q, L] rows are ~90% dead and searchsorted/expansion cost
        # scales with probe width
        K = probe_budget
        pdst = jnp.cumsum(pvalid.astype(jnp.int32)) - 1
        probe_total = pdst[-1] + 1
        pdst = jnp.where(pvalid, pdst, Q * L)

        def pcompact(v, fill):
            return (
                jnp.full(K + 1, fill, v.dtype)
                .at[jnp.minimum(pdst, K)]
                .set(v, mode="drop")[:K]
            )

        flat_k = pcompact(qkmer.reshape(-1), jnp.uint32(0xFFFFFFFF))
        p_q = pcompact(q_row, jnp.int32(Q))
        p_off = pcompact(qoff.reshape(-1), jnp.int32(0))
        p_span = pcompact(qspan.reshape(-1), jnp.int32(0))
        p_live = (jnp.arange(K) < probe_total) & (p_q < Q)
    else:
        K = Q * L
        flat_k = qkmer.reshape(-1)
        p_q = q_row
        p_off = qoff.reshape(-1)
        p_span = qspan.reshape(-1)
        p_live = pvalid
        probe_total = jnp.int32(K)
    start = jnp.searchsorted(idx_kmers, flat_k, side="left").astype(jnp.int32)
    end = jnp.searchsorted(idx_kmers, flat_k, side="right").astype(jnp.int32)
    cnt = jnp.where(p_live, end - start, 0)
    # fixed-budget expansion of posting ranges (sorted scatter + cummax,
    # avoiding slow per-slot binary search)
    from .flatops import expand_ranges

    src_c, within, alive, total = expand_ranges(cnt, budget)
    pidx = jnp.clip(start[src_c] + within, 0, post_rd.shape[0] - 1)
    q_local = jnp.clip(p_q[src_c], 0, Q - 1)
    qpos = p_off[src_c]
    span = p_span[src_c]
    cand = post_rd[pidx]
    cdir = post_dir[pidx].astype(jnp.int32)
    # filters
    qrid = qrids[q_local]
    clen = read_lens[jnp.clip(cand, 0, read_lens.shape[0] - 1)]
    keep = (
        alive
        & (cand != qrid)
        & (clen.astype(jnp.float32) <= len_ratio * qlens[q_local].astype(jnp.float32))
        & ~qskip[q_local]
    )
    if suppress.shape[1] > 0:
        keep &= ~_binary_search_rows(suppress, q_local, cand, suppress_cnt)
    # sort events by (query, candidate*2+dir, qpos); dead events to the
    # end.  (q, cand, dir) packs into ONE key when Q*(2R+2) fits int32
    # (R, Q are static) — the sort then carries 2 lanes instead of 4
    R2 = 2 * read_lens.shape[0] + 2
    assert Q * R2 < (1 << 31) - 1, "pack overflow: shard the bank (-G)"
    assert Q <= 255, "top-A key packing supports batch_q <= 255"
    kq = jnp.where(keep, q_local * R2 + cand * 2 + cdir, INT32_MAX)
    k3s = jnp.where(keep, (qpos << 8) | jnp.minimum(span, 255), INT32_MAX)
    kq, k3s = jax.lax.sort((kq, k3s), num_keys=2)
    live = kq != INT32_MAX
    qpos_s = jnp.where(live, k3s >> 8, 0)
    span_s = jnp.where(live, k3s & 0xFF, 0)
    seg_new = jnp.concatenate([jnp.ones(1, bool), kq[1:] != kq[:-1]])
    prev_end = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), (qpos_s + span_s)[:-1]])
    contrib = jnp.where(
        seg_new, span_s,
        jnp.clip(jnp.minimum(span_s, qpos_s + span_s - prev_end), 0)
    )
    contrib = jnp.where(live, contrib, 0)
    # one group per (q, cand, dir) run: reduce the covered length and keep
    # the run's key
    seg_id = jnp.cumsum(seg_new.astype(jnp.int32)) - 1
    n_seg = budget  # upper bound
    seg_ol0 = jax.ops.segment_sum(contrib, seg_id, num_segments=n_seg)
    first_idx = jnp.where(seg_new & live, seg_id, n_seg)
    seg_kq = (jnp.full(n_seg + 1, INT32_MAX, jnp.int32)
              .at[first_idx].set(kq, mode="drop")[:n_seg])
    # merge the two strands of each (q, cand) by max ol (wtzmo.c:525-535):
    # strands are adjacent in the packed key space (kq >> 1 strips dir),
    # so every merge group has <= 2 SORTED-adjacent entries — pure
    # elementwise neighbour max, no budget-wide scatters
    seg_qc = jnp.where(seg_kq == INT32_MAX, INT32_MAX, seg_kq >> 1)
    nxt_qc = jnp.concatenate([seg_qc[1:], jnp.full(1, INT32_MAX, jnp.int32)])
    nxt_ol = jnp.concatenate([seg_ol0[1:], jnp.zeros(1, jnp.int32)])
    m_new = jnp.concatenate([jnp.ones(1, bool), seg_qc[1:] != seg_qc[:-1]])
    first_live = m_new & (seg_kq != INT32_MAX)
    seg_ol = jnp.where(nxt_qc == seg_qc,
                       jnp.maximum(seg_ol0, nxt_ol), seg_ol0)
    seg_q = jnp.where(first_live, seg_qc // (R2 // 2), Q)
    seg_c = jnp.where(first_live, seg_qc % (R2 // 2), INT32_MAX)
    # top-ncand per query: sort by (q, -ol, cand); ol < 2^23 (comp length)
    # packs with q into one key lane
    seg_live = first_live & (seg_q < Q) & (seg_ol >= kovl)
    s12 = jnp.where(
        seg_live,
        (seg_q << 23) | (((1 << 23) - 1) - jnp.minimum(seg_ol, (1 << 23) - 1)),
        INT32_MAX)
    s3 = jnp.where(seg_live, seg_c, INT32_MAX)
    s12, s3 = jax.lax.sort((s12, s3), num_keys=2)
    # per-query run starts via binary search on the sorted key lane,
    # then a [Q, ncand] GATHER selects the top-ncand (no scatters)
    qkeys = jnp.arange(Q, dtype=jnp.int32) << 23
    q_first = jnp.searchsorted(s12, qkeys, side="left").astype(jnp.int32)
    idx = q_first[:, None] + jnp.arange(ncand, dtype=jnp.int32)[None, :]
    idxc = jnp.clip(idx, 0, n_seg - 1)
    v12 = s12[idxc]
    v3 = s3[idxc]
    valid = ((idx < n_seg) & (v12 != INT32_MAX)
             & ((v12 >> 23) == jnp.arange(Q, dtype=jnp.int32)[:, None]))
    cands = jnp.where(valid, v3, -1)
    ols = jnp.where(valid, ((1 << 23) - 1) - (v12 & ((1 << 23) - 1)), 0)
    return cands, ols, total, probe_total
