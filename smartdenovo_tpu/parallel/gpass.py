"""Single-chip -G multi-pass overlapper: index memory capping.

Reference wtzmo -G (wtzmo.c:1276-1303): when the posting index exceeds
memory, the reads are split into G blocks; each block is indexed in turn
and ALL queries run against the partial index, accumulating candidates;
alignment follows once every block has been seen.

Here each pass holds only its block's k16/z10 posting index on device
(~1/G of the full index); query seeds are extracted per batch from the
(replicated) base bank.  A candidate's coverage is computed entirely by
the pass owning it (read-block partition), so merging per-pass top-A
candidate lists by coverage is exact — the same argument as the
multi-chip sharded driver (parallel/sharded.py), run sequentially.
Frequency cutoffs are per pass, like the reference's per-iteration
index_wtzmo.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..data.readbank import ReadBank
from ..ops.candidates import scan_candidates
from ..ops.dotmatrix import (build_query_occ_rows, dot_matrix_align,
                             extract_zmer_pairs_sweep_rows)
from ..ops.flatseeds import flat_seeds, build_indexes_device, pad_pow2
from ..ops.seeds import extract_seeds, subsample_mask
from ..utils.log import log

INT32_MAX = np.int32(0x7FFFFFFF)

_P1_STATICS = ("Q", "Ltier", "A", "ksize", "zsize", "hz", "ksave", "kovl",
               "len_ratio", "cbud", "kq")


@functools.partial(jax.jit, static_argnames=_P1_STATICS)
def _gpass_phase1(rids_all, qlens_all, qskip_all, flat, offs, read_lens,
                  ik, ir, id_, *, Q, Ltier, A, ksize, zsize, hz, ksave,
                  kovl, len_ratio, cbud, kq):
    """Candidates for all batches against ONE pass's k16 index."""
    n = read_lens.shape[0]

    def qbatch_of(rids, qlens):
        rr = jnp.clip(rids, 0, n - 1)
        lanes = jnp.arange(Ltier, dtype=jnp.int32)[None, :]
        pos = offs[rr][:, None] + lanes
        inb = lanes < qlens[:, None]
        return jnp.where(
            inb, flat[jnp.clip(pos, 0, flat.shape[0] - 1)], jnp.uint8(4))

    def body(_, xs):
        rids, qlens, qskip = xs
        qb = qbatch_of(rids, qlens)
        kres = extract_seeds(qb, qlens, ksize, hz)
        kvalid = kres["valid"] & subsample_mask(kres["kmer"], ksave)
        cands, ols, ct, pt = scan_candidates(
            kres["kmer"], kres["off"], kres["span"], kvalid, rids, qlens,
            qskip, ik, ir, id_, read_lens,
            jnp.zeros((Q, 0), jnp.int32), jnp.zeros(Q, jnp.int32),
            budget=cbud, ncand=A, kovl=kovl, len_ratio=len_ratio,
            probe_budget=kq)
        return None, (cands, jnp.where(cands >= 0, ols, -1),
                      ct.astype(jnp.int32))

    _, (cands, ols, cts) = jax.lax.scan(
        body, None, (rids_all, qlens_all, qskip_all))
    return cands, ols, cts


_P2_STATICS = ("Q", "Ltier", "A", "zsize", "hz", "max_per_read", "occ_budget",
               "cross_budget", "nbk", "kvar", "nb", "xvar", "yvar",
               "min_block_len", "max_overhang", "deviation_penalty",
               "gap_penalty")


@functools.partial(jax.jit, static_argnames=_P2_STATICS)
def _gpass_phase2(rids_all, qlens_all, qskip_all, cand_all, flat, offs,
                  read_lens, rzsd, rzpk, rzrd, rzstart, *, Q, Ltier, A,
                  zsize, hz, max_per_read, occ_budget, cross_budget, nbk,
                  kvar, nb, xvar, yvar, min_block_len, max_overhang,
                  deviation_penalty, gap_penalty):
    """Sweep matcher + dot-matrix for all batches against ONE pass."""
    n = read_lens.shape[0]
    NP = Q * A * 2
    zbits = 2 * zsize

    def qbatch_of(rids, qlens):
        rr = jnp.clip(rids, 0, n - 1)
        lanes = jnp.arange(Ltier, dtype=jnp.int32)[None, :]
        pos = offs[rr][:, None] + lanes
        inb = lanes < qlens[:, None]
        return jnp.where(
            inb, flat[jnp.clip(pos, 0, flat.shape[0] - 1)], jnp.uint8(4))

    def body(_, xs):
        rids, qlens, qskip, csorted = xs
        qb = qbatch_of(rids, qlens)
        zres = extract_seeds(qb, qlens, zsize, hz)
        occ = build_query_occ_rows(
            zres["kmer"],
            ((zres["off"] << 9) | (jnp.minimum(zres["span"], 255) << 1)
             | zres["dir"].astype(jnp.int32)),
            zres["valid"] & ~qskip[:, None],
            occ_budget=occ_budget, zbits=zbits, max_per_read=max_per_read)
        pairs = extract_zmer_pairs_sweep_rows(
            rids, csorted, occ, rzsd, rzpk, rzrd, rzstart, read_lens,
            cross_budget=cross_budget, kvar=kvar, zbits=zbits)
        res = dot_matrix_align(
            pairs,
            jnp.repeat(qlens, A * 2),
            jnp.repeat(jnp.where(
                csorted < n, read_lens[jnp.clip(csorted, 0, n - 1)], 0
            ).astype(jnp.int32).reshape(-1), 2),
            n_pairs=NP, nb=nb, xvar=xvar, yvar=yvar,
            min_block_len=min_block_len, max_overhang=max_overhang,
            deviation_penalty=deviation_penalty, gap_penalty=gap_penalty,
            nbk=nbk)
        rows = jnp.minimum(res.pair_id, NP)
        live = (res.pair_id < NP) & (res.score > 0)

        def posit(v):
            return jnp.zeros(NP + 1, jnp.int32).at[rows].max(
                v.astype(jnp.int32), mode="drop")[:NP]

        pack = jnp.stack([
            posit(jnp.where(live, res.score, 0)),
            posit(jnp.where(live, res.tb, 0)),
            posit(jnp.where(live, res.te, 0)),
            posit(jnp.where(live, res.qb, 0)),
            posit(jnp.where(live, res.qe, 0)),
            res.match_cnt,
        ])
        totals = jnp.stack([pairs.total, pairs.expand_total, res.blk_total,
                            jnp.int32(0)])
        return None, (pack, totals)

    _, (packs, totals) = jax.lax.scan(
        body, None, (rids_all, qlens_all, qskip_all, cand_all))
    return packs, totals


def overlap_gparts(rb: ReadBank, params=None, progress: bool = True,
                   parts: int = 1, part: int = 0):
    """Multi-pass (-G) all-vs-all overlap: only 1/G of the posting index
    is resident per pass.  Returns the same Overlap list as overlap_dmo
    (pair set exact modulo top-A coverage ties at the candidate cut)."""
    from ..pipeline.zmo import ZmoParams, _emit_batch_dm, _pad_tier

    p = params or ZmoParams.dmo()
    G = max(1, p.gparts)
    n = len(rb)
    if n == 0:
        return []
    A = min(p.dm_cand, p.ncand) if p.dm_cand > 0 else p.ncand
    Q = p.batch_q
    Ltier = _pad_tier(int(rb.lengths[0]) if n else 1024)
    m = (n + G - 1) // G
    bounds = np.minimum(np.arange(G + 1) * m, n)
    # replicated base bank (the INDEX is the memory hog, ~10-20x the bank)
    total = rb.total_bases
    flat = np.full(pad_pow2(total + 1), 4, np.uint8)
    flat[:total] = rb.bases
    offs_pad = np.full(pad_pow2(n + 1, lo=1 << 8), total, np.int32)
    offs_pad[: n + 1] = rb.offsets.astype(np.int32)
    flat_d = jnp.asarray(flat)
    offs_d = jnp.asarray(offs_pad)
    read_lens_d = jnp.asarray(rb.lengths.astype(np.int32))

    qarr = np.arange(n) if parts <= 1 else np.arange(n)[part::parts]
    batches = [qarr[i: i + Q] for i in range(0, len(qarr), Q)]
    B = len(batches)
    rids_all = np.zeros((B, Q), np.int32)
    qlens_all = np.zeros((B, Q), np.int32)
    qskip_all = np.ones((B, Q), bool)
    for bi, b in enumerate(batches):
        rids_all[bi, : len(b)] = b
        rids_all[bi, len(b):] = b[-1]
        qlens_all[bi] = rb.lengths[rids_all[bi]]
        qskip_all[bi, : len(b)] = False
    rids_d = jnp.asarray(rids_all)
    qlens_d = jnp.asarray(qlens_all)
    qskip_d = jnp.asarray(qskip_all)

    NP = Q * A * 2
    best_c = np.full((B, Q, G * A), INT32_MAX, np.int32)
    best_o = np.full((B, Q, G * A), -1, np.int32)

    def build_part(g):
        lo, hi = int(bounds[g]), int(bounds[g + 1])
        ptot = int(rb.offsets[hi] - rb.offsets[lo])
        pflat = np.full(pad_pow2(ptot + 1), 4, np.uint8)
        pflat[:ptot] = rb.bases[rb.offsets[lo]: rb.offsets[hi]]
        Npad = pad_pow2(n, lo=1 << 8)
        poffs = np.full(Npad + 1, ptot, np.int64)
        poffs[: hi - lo + 1] = rb.offsets[lo: hi + 1] - rb.offsets[lo]
        k16 = flat_seeds(jnp.asarray(pflat),
                         jnp.asarray(poffs.astype(np.int32)), p.ksize, p.hz)
        z10 = flat_seeds(jnp.asarray(pflat),
                         jnp.asarray(poffs.astype(np.int32)), p.zsize, p.hz)
        didx = build_indexes_device(
            k16, z10, ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
            max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
        # rebase local read ids -> global
        live_k = didx.k_kmers != jnp.uint32(0xFFFFFFFF)
        k_rd = jnp.where(live_k, didx.k_rd + lo, didx.k_rd)
        nz = didx.rm_start[hi - lo]
        Ts = didx.rm_rd.shape[0]
        rm_rd = jnp.where(jnp.arange(Ts) < nz, didx.rm_rd + lo, n)
        st_l = didx.rm_start
        rm_start = jnp.concatenate([
            jnp.zeros(lo, jnp.int32), st_l[: hi - lo + 1],
            jnp.full(max(0, n - hi), st_l[hi - lo], jnp.int32)])
        return (didx.k_kmers, k_rd, didx.k_dir,
                didx.rm_zsd, didx.rm_pk, rm_rd, rm_start,
                np.asarray(didx.stats), lo, hi)

    # ---- pass 1 over parts: candidates ----
    stats_parts = []
    for g in range(G):
        ik, ir, idr, rzsd, rzpk, rzrd, rzstart, stats, lo, hi = build_part(g)
        stats_parts.append((stats, lo, hi))
        Npad = pad_pow2(n, lo=1 << 8)
        # batch expansion against this pass cannot exceed its posting
        # total — the budget stays O(part index), i.e. -G's memory goal
        n_post = int(stats[5 * Npad + 2])
        cbud = pad_pow2(n_post + (1 << 12), lo=1 << 14)
        kq = pad_pow2(Q * Ltier // max(1, p.ksave), lo=1 << 12)
        cands, ols, _cts = _gpass_phase1(
            rids_d, qlens_d, qskip_d, flat_d, offs_d, read_lens_d,
            ik, ir, idr, Q=Q, Ltier=Ltier, A=A, ksize=p.ksize,
            zsize=p.zsize, hz=p.hz, ksave=p.ksave, kovl=p.kovl,
            len_ratio=p.len_ratio, cbud=min(cbud, p.expand_budget_cap),
            kq=kq)
        best_c[:, :, g * A:(g + 1) * A] = np.asarray(cands)
        best_o[:, :, g * A:(g + 1) * A] = np.asarray(ols)
        if progress:
            log("gpass %d/%d: indexed reads [%d, %d), candidates merged",
                g + 1, G, lo, hi)
    # exact top-A merge (each candidate scored by exactly one pass)
    best_c = np.where(best_o > 0, best_c, INT32_MAX)
    ordi = np.argsort(np.where(best_c == INT32_MAX, -1, best_o) * -1,
                      axis=2, kind="stable")[:, :, :A]
    merged_c = np.take_along_axis(best_c, ordi, axis=2)
    csorted_all = np.sort(merged_c, axis=2).astype(np.int32)
    cand_d = jnp.asarray(csorted_all.reshape(B, Q * A))

    # ---- pass 2 over parts: matching + chaining ----
    packs = np.zeros((B, 6, NP), np.int64)
    zcnt_own = np.zeros(n, np.int64)
    cross_own = np.zeros(n, np.int64)
    Npad = pad_pow2(n, lo=1 << 8)
    for stats, lo, hi in stats_parts:
        zcnt_own[lo:hi] = stats[: hi - lo]
        cross_own[lo:hi] = stats[4 * Npad: 4 * Npad + hi - lo]
    occ_budget = pad_pow2(max(int(zcnt_own[rids_all[bi]].sum())
                              for bi in range(B)) + Q, lo=1 << 12)
    cross_budget = min(pad_pow2(2 * max(int(cross_own[rids_all[bi]].sum())
                                        for bi in range(B)) + 1024,
                                lo=1 << 14), p.expand_budget_cap)
    for g in range(G):
        ik, ir, idr, rzsd, rzpk, rzrd, rzstart, stats, lo, hi = build_part(g)
        pk, tot = _gpass_phase2(
            rids_d, qlens_d, qskip_d,
            cand_d.reshape(B, Q, A), flat_d, offs_d, read_lens_d,
            rzsd, rzpk, rzrd, rzstart,
            Q=Q, Ltier=Ltier, A=A, zsize=p.zsize, hz=p.hz,
            max_per_read=p.max_zmer_freq, occ_budget=occ_budget,
            cross_budget=cross_budget, nbk=max(cross_budget // 4, 1 << 14),
            kvar=p.kvar, nb=p.nb, xvar=p.xvar, yvar=p.yvar,
            min_block_len=p.min_block_len, max_overhang=p.max_overhang,
            deviation_penalty=p.deviation_penalty, gap_penalty=p.gap_penalty)
        pk = np.asarray(pk)
        # overflow check (ADVICE r4): this driver has no redispatch loop —
        # surface truncation loudly instead of silently dropping overlaps
        tot = np.asarray(tot)
        nbk_budget = max(cross_budget // 4, 1 << 14)
        if int(tot[:, 1].max()) > cross_budget:
            log("WARNING: gpass %d expansion %d exceeds budget %d; matches "
                "dropped — raise -G or budgets", g + 1,
                int(tot[:, 1].max()), cross_budget)
        if int(tot[:, 2].max()) > nbk_budget:
            log("WARNING: gpass %d block mass %d exceeds merge budget %d; "
                "overlaps may be dropped", g + 1, int(tot[:, 2].max()),
                nbk_budget)
        # combine: a (q, slot) pair is produced by exactly one pass
        packs[:, :5] = np.where(pk[:, :1] > packs[:, :1], pk[:, :5],
                                packs[:, :5])
        packs[:, 5] += pk[:, 5]
        if progress:
            log("gpass %d/%d: matched + chained", g + 1, G)

    # ---- host emission (single-chip semantics) ----
    overlaps: list = []
    emitted: set = set()
    rdcovs = np.zeros(n, np.int64)
    rdmask = np.zeros(n, bool)
    avg_len = rb.avg_len()
    pos = np.arange(NP, dtype=np.int64)
    for bi in range(B):
        row = np.concatenate([
            pos, packs[bi, 0], packs[bi, 1], packs[bi, 2], packs[bi, 3],
            packs[bi, 4], packs[bi, 5], np.zeros(4, np.int64)])
        _emit_batch_dm(rb, p, rids_all[bi], row, csorted_all[bi], Q, A,
                       rdcovs, rdmask, overlaps, emitted, set(), None,
                       avg_len)
    if progress:
        log("overlap (-G %d passes) done: %d overlaps", G, len(overlaps))
    return overlaps
