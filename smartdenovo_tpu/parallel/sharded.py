"""Multi-chip sharded overlap step — the pod-scale execution path.

Design (SURVEY.md §5.8; replaces the reference's -P/-p job split and -G
index partitioning, wtzmo.c:1431-1463) — EXACT single-chip semantics:

  mesh axes:  rd  — data parallel over query batches
              idx — the read bank (and both posting indexes) sharded by
                    contiguous read-id blocks

  Sharding the index by READ ID (not kmer hash) makes candidate scoring
  local-exact: a candidate's postings live entirely on its own shard, so
  the per-(query, candidate) k-mer union length — the reference's
  coverage score (wtzmo.c:1251-1357) — is computed exactly by one shard.
  The step then needs only two collectives:

    1. all_gather over `idx` of each shard's local top-A candidate list
       -> exact global top-A per query (a candidate appears on exactly
       one shard, so merging per-shard top-A lists is lossless);
    2. psum over `idx` of the positional dot-matrix result arrays (each
       pair is chained by exactly one shard, the candidate's).

  Everything else is the single-chip pipeline (ops/candidates
  scan_candidates, ops/dotmatrix sweep matcher + dot_matrix_align) run
  per shard — no approximations, no dense [Q, n_reads] buffers, no
  candidate caps beyond the single-chip -A itself.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.candidates import scan_candidates
from ..ops.dotmatrix import (build_query_occ_rows, dot_matrix_align,
                             extract_zmer_pairs_sweep_rows)
from ..ops.flatseeds import flat_seeds, build_indexes_device, pad_pow2
from ..ops.seeds import extract_seeds, subsample_mask
from ..utils.log import log

INT32_MAX = np.int32(0x7FFFFFFF)


def make_overlap_mesh(devices=None, idx_shards: int | None = None) -> Mesh:
    """Build a (rd, idx) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if idx_shards is None:
        idx_shards = 2 if n % 2 == 0 and n >= 4 else 1
    rd = n // idx_shards
    dev = np.array(devices[: rd * idx_shards]).reshape(rd, idx_shards)
    return Mesh(dev, ("rd", "idx"))


class ShardedBank(NamedTuple):
    """Per-shard device indexes, stacked on a leading idx axis."""

    k_kmers: jnp.ndarray   # [S, Ts] uint32
    k_rd: jnp.ndarray      # [S, Ts] int32 (global read ids)
    k_dir: jnp.ndarray     # [S, Ts] int8
    rm_zsd: jnp.ndarray    # [S, Ts] int32
    rm_pk: jnp.ndarray     # [S, Ts] int32
    rm_rd: jnp.ndarray     # [S, Ts] int32 (global read ids)
    rm_start: jnp.ndarray  # [S, n+1] int32 GLOBAL-read CSR (0-width rows
                           #          for reads owned by other shards)
    bounds: np.ndarray     # [S+1] shard read-id boundaries (host)
    stats: np.ndarray      # host copy of per-shard stat packs [S, ...]
    kneed: np.ndarray      # [n] per-read GLOBAL k16 expansion need


def shard_bounds(n: int, S: int) -> np.ndarray:
    m = (n + S - 1) // S
    return np.minimum(np.arange(S + 1) * m, n)


def shard_tier(rb, bounds) -> int:
    """Common posting tier across shards (one compile of the builder)."""
    Ts = 1
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        Ts = max(Ts, pad_pow2(int(rb.offsets[hi] - rb.offsets[lo]) + 1))
    return Ts


def build_one_shard(rb, p, lo: int, hi: int, Ts: int, Npad: int):
    """Build ONE read-block shard's indexes with the single-chip builder.

    Returns host arrays: raw sampled k16 postings (kmer, global rd, dir —
    unfiltered: the frequency rule must see GLOBAL counts), the read-major
    zmer arrays (global read ids), the global-read CSR row, and the stats
    pack.  Used by both the single-process builder and the multi-host
    path (each process builds only its own shards)."""
    from ..ops.flatseeds import RM_BLK

    n = len(rb)
    total = int(rb.offsets[hi] - rb.offsets[lo])
    Tz = Ts + Npad * RM_BLK
    flat = np.full(Ts, 4, np.uint8)
    flat[:total] = rb.bases[rb.offsets[lo]: rb.offsets[hi]]
    offs = np.full(Npad + 1, total, np.int64)
    offs[: hi - lo + 1] = rb.offsets[lo: hi + 1] - rb.offsets[lo]
    flat_d = jnp.asarray(flat)
    offs_d = jnp.asarray(offs.astype(np.int32))
    k16 = flat_seeds(flat_d, offs_d, p.ksize, p.hz)
    z10 = flat_seeds(flat_d, offs_d, p.zsize, p.hz)
    didx = build_indexes_device(
        k16, z10, ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
        max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
    kval = np.asarray(k16.valid & subsample_mask(k16.kmer, p.ksave))
    local_n = hi - lo
    st_l = np.asarray(didx.rm_start)
    n_live_z = int(st_l[local_n])
    rst = np.zeros(n + 1, np.int32)
    rst[lo: hi + 1] = st_l[: local_n + 1]
    rst[hi + 1:] = st_l[local_n]
    return dict(
        raw_k=np.asarray(k16.kmer)[kval],
        raw_rd=np.asarray(k16.comp_rd)[kval] + lo,
        raw_dir=(np.asarray(k16.aux)[kval] & 1).astype(np.int8),
        zsd=np.asarray(didx.rm_zsd),
        zpk=np.asarray(didx.rm_pk),
        zrd=np.where(np.arange(Tz) < n_live_z,
                     np.asarray(didx.rm_rd) + lo, n).astype(np.int32),
        rst=rst,
        stats=np.asarray(didx.stats),
    )


def k16_freq_rule(counts: np.ndarray, max_kmer_freq: int) -> np.ndarray:
    """The reference's k-mer frequency keep rule on GLOBAL counts
    (wtzmo.c:380-418): drop singletons and over-frequent kmers."""
    n_post = int(counts.sum())
    kavg = max(n_post // max(1, len(counts)), 20)
    cutoff = max_kmer_freq if max_kmer_freq >= 2 else max(kavg * 5, 100)
    return (counts > 1) & (counts <= cutoff)


def filter_shard_k16(shard, uniq, keep_kmer, Ts, kneed_g=None):
    """Apply the global frequency rule to one shard's raw k16 postings and
    lay them out (kmer, rd)-sorted in the common tier."""
    ki = np.searchsorted(uniq, shard["raw_k"])
    ok = keep_kmer[ki]
    km, rd_, dr = shard["raw_k"][ok], shard["raw_rd"][ok], shard["raw_dir"][ok]
    order = np.lexsort((rd_, km))
    cnt = len(km)
    if cnt > Ts:
        raise ValueError("k16 postings exceed shard tier")
    kk = np.full(Ts, 0xFFFFFFFF, np.uint32)
    krd = np.zeros(Ts, np.int32)
    kdr = np.zeros(Ts, np.int8)
    kk[:cnt] = km[order]
    krd[:cnt] = rd_[order]
    kdr[:cnt] = dr[order]
    return kk, krd, kdr


def build_sharded_indexes(rb, p, mesh: Mesh) -> ShardedBank:
    """Build each shard's posting indexes with the single-chip builder.

    Reads are partitioned into contiguous blocks.  Each shard is built
    independently (`build_one_shard`) and device_put to its idx position
    immediately — peak host memory is ONE shard's staging, not S of them
    (VERDICT r2 weak #9).  The k16 frequency filter uses GLOBAL counts
    (a shard-local filter would drop 2-frequency kmers split across
    shards — precisely the overlap signal)."""
    n = len(rb)
    S = mesh.devices.shape[1]
    bounds = shard_bounds(n, S)
    Ts = shard_tier(rb, bounds)
    Npad = pad_pow2(n, lo=1 << 8)

    sharding = NamedSharding(mesh, P("idx"))
    # device buffers per field, filled shard by shard: peak host memory is
    # one shard's staging + the (small) raw k16 arrays kept for the
    # global frequency pass
    shard_devs = {}   # s -> list of devices holding idx-shard s
    for d, idx in sharding.addressable_devices_indices_map((S, 1)).items():
        shard_devs.setdefault(idx[0].start, []).append(d)
    fields = ("zsd", "zpk", "zrd", "rst")
    bufs = {f: {} for f in ("kk", "krd", "kdr") + fields}
    raw = []          # per-shard raw k16 postings for the global filter
    stats_all = []
    for s in range(S):
        sh = build_one_shard(rb, p, bounds[s], bounds[s + 1], Ts, Npad)
        for f in fields:
            for d in shard_devs.get(s, ()):
                bufs[f].setdefault(s, []).append(
                    jax.device_put(sh[f][None], d))
        raw.append((sh["raw_k"], sh["raw_rd"], sh["raw_dir"]))
        stats_all.append(sh["stats"])
        del sh

    # ---- global k16 frequency filter (reference wtzmo.c:380-418) ----
    allk = (np.concatenate([r[0] for r in raw])
            if raw else np.zeros(0, np.uint32))
    uniq, counts = np.unique(allk, return_counts=True)
    del allk
    keep_kmer = k16_freq_rule(counts, p.max_kmer_freq)
    kneed_g = np.zeros(n, np.int64)   # per-read global expansion need
    for s, (raw_k, raw_rd, raw_dir) in enumerate(raw):
        kk, krd, kdr = filter_shard_k16(
            dict(raw_k=raw_k, raw_rd=raw_rd, raw_dir=raw_dir),
            uniq, keep_kmer, Ts)
        ki = np.searchsorted(uniq, raw_k)
        ok = keep_kmer[ki]
        np.add.at(kneed_g, raw_rd[ok], counts[ki][ok])
        for d in shard_devs.get(s, ()):
            bufs["kk"].setdefault(s, []).append(jax.device_put(kk[None], d))
            bufs["krd"].setdefault(s, []).append(jax.device_put(krd[None], d))
            bufs["kdr"].setdefault(s, []).append(jax.device_put(kdr[None], d))

    def assemble(f):
        flat = [b for s in sorted(bufs[f]) for b in bufs[f][s]]
        shape = (S,) + flat[0].shape[1:]
        return jax.make_array_from_single_device_arrays(shape, sharding, flat)

    return ShardedBank(
        k_kmers=assemble("kk"), k_rd=assemble("krd"), k_dir=assemble("kdr"),
        rm_zsd=assemble("zsd"), rm_pk=assemble("zpk"), rm_rd=assemble("zrd"),
        rm_start=assemble("rst"),
        bounds=bounds, stats=np.stack(stats_all),
        kneed=kneed_g,
    )


def sharded_overlap_step(mesh: Mesh, *, n_reads: int, Q: int, A: int,
                         kovl: int, len_ratio: float, ksave: int,
                         cbud: int, kq: int, occ_budget: int,
                         cross_budget: int, nbk: int, kvar: int, zbits: int,
                         max_per_read: int, nb: int, xvar: int, yvar: int,
                         min_block_len: int, max_overhang: int,
                         deviation_penalty: float, gap_penalty: float):
    """Jitted multi-chip overlap step (fixed shapes).

    Per (rd, idx) device: single-chip candidate scan against the local
    index shard -> all_gather + exact top-A merge -> single-chip sweep
    matcher + dot-matrix on the local shard -> psum of positional
    results.  Returns per-rd-shard packed arrays (host emits).
    """
    def step(qk, qoff, qspan, qvalid, zk, zoff, zspan, zdir, zvalid,
             qrids, qlens, qskip, read_lens,
             ik, ir, id_, rzsd, rzpk, rzrd, rzstart):
        Ql = qk.shape[0]           # local queries on this rd shard
        NP = Ql * A * 2
        ik, ir, id_ = ik[0], ir[0], id_[0]
        rzsd, rzpk, rzrd, rzstart = rzsd[0], rzpk[0], rzrd[0], rzstart[0]
        kvalid = qvalid & subsample_mask(qk, ksave)
        sup0 = jnp.zeros((Ql, 0), jnp.int32)
        supc0 = jnp.zeros((Ql,), jnp.int32)
        cands, ols, cand_total, probe_total = scan_candidates(
            qk, qoff, qspan, kvalid, qrids, qlens, qskip,
            ik, ir, id_, read_lens, sup0, supc0,
            budget=cbud, ncand=A, kovl=kovl, len_ratio=len_ratio,
            probe_budget=kq,
        )
        # ---- exact top-A merge over idx shards ----
        ag_c = jax.lax.all_gather(cands, axis_name="idx", axis=1)  # [Ql,S,A]
        ag_o = jax.lax.all_gather(ols, axis_name="idx", axis=1)
        Sn = ag_c.shape[1]
        flat_c = ag_c.reshape(Ql, Sn * A)
        flat_o = jnp.where(flat_c >= 0, ag_o.reshape(Ql, Sn * A), -1)
        top_o, top_i = jax.lax.top_k(flat_o, A)
        gc = jnp.take_along_axis(flat_c, top_i, axis=1)
        gc = jnp.where(top_o > 0, gc, jnp.int32(INT32_MAX))
        csorted = jnp.sort(gc, axis=1)
        # ---- single-chip sweep matcher against the local z shard ----
        occ = build_query_occ_rows(
            zk, ((zoff << 9) | (jnp.minimum(zspan, 255) << 1)
                 | zdir.astype(jnp.int32)),
            zvalid & ~qskip[:, None],
            occ_budget=occ_budget, zbits=zbits, max_per_read=max_per_read)
        pairs = extract_zmer_pairs_sweep_rows(
            qrids, csorted, occ, rzsd, rzpk, rzrd, rzstart, read_lens,
            cross_budget=cross_budget, kvar=kvar, zbits=zbits)
        res = dot_matrix_align(
            pairs,
            jnp.repeat(qlens, A * 2),
            jnp.repeat(jnp.where(
                csorted < n_reads,
                read_lens[jnp.clip(csorted, 0, n_reads - 1)], 0
            ).astype(jnp.int32).reshape(-1), 2),
            n_pairs=NP, nb=nb, xvar=xvar, yvar=yvar,
            min_block_len=min_block_len, max_overhang=max_overhang,
            deviation_penalty=deviation_penalty, gap_penalty=gap_penalty,
            nbk=nbk,
        )
        # ---- positional scatter + psum (each pair on exactly 1 shard) ----
        rows = jnp.minimum(res.pair_id, NP)

        def posit(v):
            return jnp.zeros(NP + 1, jnp.int32).at[rows].max(
                v.astype(jnp.int32), mode="drop")[:NP]

        live = (res.pair_id < NP) & (res.score > 0)
        packed = jnp.stack([
            posit(jnp.where(live, res.score, 0)),
            posit(jnp.where(live, res.tb, 0)),
            posit(jnp.where(live, res.te, 0)),
            posit(jnp.where(live, res.qb, 0)),
            posit(jnp.where(live, res.qe, 0)),
            res.match_cnt,     # already positional [NP]
        ])
        packed = jax.lax.psum(packed, axis_name="idx")
        totals = jax.lax.psum(jnp.stack([
            pairs.total, pairs.expand_total, res.blk_total,
            cand_total.astype(jnp.int32)]), axis_name="idx")[None, :]
        return csorted, packed, totals

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("rd", None), P("rd", None), P("rd", None), P("rd", None),
            P("rd", None), P("rd", None), P("rd", None), P("rd", None),
            P("rd", None),
            P("rd"), P("rd"), P("rd"), P(),
            P("idx"), P("idx"), P("idx"),
            P("idx"), P("idx"), P("idx"), P("idx"),
        ),
        out_specs=(P("rd", None), P(None, "rd"), P("rd", None)),
        check_vma=False,
    )
    return jax.jit(fn)


def overlap_sharded(rb, params=None, mesh: Mesh | None = None,
                    progress: bool = True):
    """Multi-device overlap driver with single-chip-identical semantics.

    Streams query batches over the rd axis against the idx-sharded bank;
    host emission reuses the single-chip `_emit_batch_dm` (same nbest /
    ledger / dedup replay), so the pair set equals `overlap_dmo`'s.
    """
    from ..pipeline.zmo import ZmoParams, Overlap, _pad_tier, _emit_batch_dm

    p = params or ZmoParams.dmo()
    mesh = mesh or make_overlap_mesh()
    n_rd, n_idx = mesh.devices.shape
    n = len(rb)
    if n == 0:
        return []
    sb = build_sharded_indexes(rb, p, mesh)
    Npad = pad_pow2(n, lo=1 << 8)
    st = sb.stats  # [S, 5*Npad+3]; per-read blocks are in LOCAL shard ids
    zcnt = np.zeros(n, np.int64)        # per-read z postings (own shard)
    kprobes = np.zeros(n, np.int64)
    cross = np.zeros(n, np.int64)
    for s in range(st.shape[0]):
        lo, hi = int(sb.bounds[s]), int(sb.bounds[s + 1])
        ln = hi - lo
        zcnt[lo:hi] = st[s, :ln]
        kprobes[lo:hi] = st[s, 2 * Npad: 2 * Npad + ln]
        cross[lo:hi] = st[s, 4 * Npad: 4 * Npad + ln]
    kneed = sb.kneed                    # GLOBAL (exact per-shard bound)
    comp_max = int(st[:, 5 * Npad].max())

    A = min(p.ncand, p.dm_cand) if p.dm_cand > 0 else p.ncand
    Qloc = max(1, p.batch_q // max(1, n_rd))
    Q = Qloc * n_rd
    Ltier = _pad_tier(int(rb.lengths.max()))
    read_lens = jnp.asarray(rb.lengths.astype(np.int32))
    batches = [np.arange(n)[i: i + Q] for i in range(0, n, Q)]
    # budgets: the own-shard per-read stats estimate the per-shard masses
    # (a shard holds ~1/S of the genome's copies, so own-shard ~= any
    # shard's share); x2 slack + overflow counters in `totals`
    cbud = pad_pow2(max(int(kneed[b].sum()) for b in batches) + 1024,
                    lo=1 << 14)
    kq = pad_pow2(max(int(kprobes[b].sum()) for b in batches) + Q, lo=1 << 12)
    occ_budget = pad_pow2(max(int(zcnt[b].sum()) for b in batches) + Q,
                          lo=1 << 12)
    cross_budget = pad_pow2(2 * max(int(cross[b].sum()) for b in batches)
                            + 1024, lo=1 << 14)
    step = sharded_overlap_step(
        mesh, n_reads=n, Q=Q, A=A, kovl=p.kovl, len_ratio=p.len_ratio,
        ksave=p.ksave, cbud=cbud, kq=kq, occ_budget=occ_budget,
        cross_budget=cross_budget, nbk=max(cross_budget // 4, 1 << 14),
        kvar=p.kvar, zbits=2 * p.zsize, max_per_read=p.max_zmer_freq,
        nb=p.nb, xvar=p.xvar, yvar=p.yvar, min_block_len=p.min_block_len,
        max_overhang=p.max_overhang, deviation_penalty=p.deviation_penalty,
        gap_penalty=p.gap_penalty,
    )
    overlaps: list = []
    emitted_pairs: set = set()
    rdcovs = np.zeros(n, np.int64)
    rdmask = np.zeros(n, bool)
    avg_len = rb.avg_len()
    for b in batches:
        rids = np.concatenate(
            [b, np.full(Q - len(b), b[-1], b.dtype)]).astype(np.int32)
        qskip = np.zeros(Q, bool)
        qskip[len(b):] = True
        batch, lens = rb.batch(rids, pad_to=Ltier)
        kres = extract_seeds(jnp.asarray(batch), jnp.asarray(lens),
                             p.ksize, p.hz)
        zres = extract_seeds(jnp.asarray(batch), jnp.asarray(lens),
                             p.zsize, p.hz)
        csorted, packed, totals = step(
            kres["kmer"], kres["off"], kres["span"], kres["valid"],
            zres["kmer"], zres["off"], zres["span"],
            zres["dir"], zres["valid"],
            jnp.asarray(rids), jnp.asarray(lens.astype(np.int32)),
            jnp.asarray(qskip), read_lens,
            sb.k_kmers, sb.k_rd, sb.k_dir,
            sb.rm_zsd, sb.rm_pk, sb.rm_rd, sb.rm_start,
        )
        csorted = np.asarray(csorted)
        packed = np.asarray(packed)
        # overflow check (ADVICE r4): the single-chip driver redispatches on
        # these counters; here budgets are static per run (recompile cost),
        # so surface truncation loudly instead of silently dropping overlaps
        tmax = np.asarray(totals).max(axis=0).astype(np.int64)
        nbk_budget = max(cross_budget // 4, 1 << 14)
        if tmax[1] > cross_budget:
            log("WARNING: sharded batch expansion %d exceeds budget %d; "
                "matches dropped — raise batch_q shards or budgets",
                int(tmax[1]), cross_budget)
        if tmax[2] > nbk_budget:
            log("WARNING: sharded batch block mass %d exceeds merge budget "
                "%d; overlaps may be dropped", int(tmax[2]), nbk_budget)
        NP = Q * A * 2
        # pack rows in the single-chip emit layout
        pos = np.arange(NP, dtype=np.int64)
        row = np.concatenate([
            pos,                       # pair_id (positional)
            packed[0], packed[1], packed[2], packed[3], packed[4],
            packed[5],
            np.asarray(totals).max(axis=0).astype(np.int64),
        ])
        _emit_batch_dm(rb, p, rids, row, csorted, Q, A, rdcovs, rdmask,
                       overlaps, emitted_pairs, set(), None, avg_len)
        if progress:
            log("sharded overlap %d/%d reads, %d overlaps",
                min(n, int(b[-1]) + 1), n, len(overlaps))
    return overlaps
