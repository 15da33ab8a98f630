#!/usr/bin/env python
"""Sub-phase profiler for the overlap pipeline on the device.

Reconstructs batch-0 of the bench dataset exactly as overlap_dmo does,
then times each phase-2 sub-stage in isolation (separately jitted, warm,
synced via a small dependent fetch).  Inputs are varied per rep.

Usage: python scripts/profile_zmo.py [--fasta work/bench_reads.fa]
                                     [--reps 3] [--batch N]
Writes a phase table to stdout and work/profile_zmo.json.
"""

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fasta", default=os.path.join(ROOT, "work", "bench_reads.fa"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="substring filter: time only matching sections")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.ops.dotmatrix import (dot_matrix_align,
                                               extract_zmer_pairs_join)
    from smartdenovo_tpu.ops.flatseeds import (build_indexes_device,
                                               flat_seeds, gather_query_rows)
    from smartdenovo_tpu.pipeline import zmo as Z
    from smartdenovo_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    rb = ReadBank.from_fasta(args.fasta)
    p = Z.ZmoParams.dmo()
    n = len(rb)
    flat_d, offs_d, lens_d, T, Npad = Z._upload_bank(rb)
    k16 = flat_seeds(flat_d, offs_d, p.ksize, p.hz)
    z10 = flat_seeds(flat_d, offs_d, p.zsize, p.hz)
    didx = build_indexes_device(
        k16, z10, lens_d, ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
        max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
    stats = np.asarray(didx.stats)
    zcnt = stats[:Npad][:n].astype(np.int64)
    kneed = stats[Npad: 2 * Npad][:n].astype(np.int64)
    kprobes = stats[2 * Npad: 3 * Npad][:n].astype(np.int64)
    comp_len = stats[3 * Npad: 4 * Npad][:n].astype(np.int64)
    max_comp = int(stats[5 * Npad])

    A = p.ncand
    Adm = min(p.dm_cand, A) if p.dm_cand > 0 else A
    Q = p.batch_q
    Lc = Z.pad_pow2(max_comp, lo=1 << 10)
    read_lens_d = jnp.asarray(rb.lengths.astype(np.int32))
    qarr = np.arange(n)
    batches = [qarr[i: i + Q] for i in range(0, len(qarr), Q)]
    b = batches[args.batch]
    rids = np.concatenate([b, np.full(Q - len(b), b[-1], b.dtype)]).astype(np.int32)
    qlens = rb.lengths[rids].astype(np.int32)
    qskip = np.zeros(Q, bool)
    qskip[len(b):] = True

    cbud = min(Z.pad_pow2(int(kneed[b].sum()) + 1024, lo=1 << 14),
               p.expand_budget_cap)
    kq = Z.pad_pow2(int(kprobes[b].sum()) + Q, lo=1 << 12)
    cand_static = dict(Q=Q, Lc=Lc, A=A, Adm=Adm, cbud=cbud, kq=kq,
                       ksave=p.ksave, kovl=p.kovl, len_ratio=p.len_ratio)
    cb, _ob, sb = Z._cand_scan_device(
        jnp.asarray(rids[None]), jnp.asarray(qlens[None]),
        jnp.asarray(qskip[None]), k16, didx, read_lens_d, **cand_static)
    sizes = np.asarray(sb)[0]
    csorted = cb[0].reshape(Q, Adm)

    zneed = int(sizes[0])
    mb = min(Z.pad_pow2(zneed + 1024, lo=1 << 14), p.expand_budget_cap)
    pb = min(Z.pad_pow2(zneed * 4 // 5 + 1024, lo=1 << 14), mb)
    nbk = max(pb // 4, 1 << 14)
    qkb = Z.pad_pow2(int(comp_len[b].sum()) + Q, lo=1 << 12)
    print(f"batch {args.batch}: zneed={zneed} mb={mb} pb={pb} nbk={nbk} "
          f"qkb={qkb} Lc={Lc}", flush=True)

    zk, zoff, zspan, zdir, zvalid = gather_query_rows(z10, jnp.asarray(rids), Lc)
    rids_d = jnp.asarray(rids)
    qlens_d = jnp.asarray(qlens)

    def sync(x):
        return float(np.asarray(jnp.sum(x.astype(jnp.int32) if x.dtype == jnp.bool_ else x)))

    results = {}

    def timeit(name, fn, *xs):
        if args.only and args.only not in name:
            return
        # warmup (compile)
        out = fn(0, *xs)
        sync(out if not isinstance(out, tuple) else out[0])
        ts = []
        for r in range(1, args.reps + 1):
            t0 = time.time()
            out = fn(r, *xs)
            sync(out if not isinstance(out, tuple) else out[0])
            ts.append(time.time() - t0)
        best = min(ts)
        results[name] = best
        print(f"  {name:45s} {best * 1e3:9.1f} ms  (all: "
              + " ".join(f"{t*1e3:.0f}" for t in ts) + ")", flush=True)

    # ---- index build + phase 1 (candidate scan), timed in isolation ----
    def idx_vary(r, fd):
        k16v = flat_seeds(fd, offs_d, p.ksize, p.hz)
        z10v = flat_seeds(fd, offs_d, p.zsize, p.hz)
        dv = build_indexes_device(
            k16v, z10v, lens_d, ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
            max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
        return dv.stats

    timeit("index build (flat_seeds x2 + sort/filter)",
           lambda r, fd: idx_vary(r, jnp.where(
               jnp.arange(fd.shape[0], dtype=jnp.int32) == (r % 97),
               jnp.uint8(0), fd)), flat_d)

    def p1_vary(r, rids_v, qlens_v, qskip_v):
        cb1, _o, sb1 = Z._cand_scan_device(
            rids_v[None], qlens_v[None], qskip_v[None], k16, didx,
            read_lens_d, **cand_static)
        return sb1

    timeit("phase1 candidate scan (1 batch)",
           lambda r, *xs: p1_vary(r, jnp.roll(jnp.asarray(rids), r),
                                  jnp.roll(jnp.asarray(qlens), r),
                                  jnp.asarray(qskip)), 0)

    jkw = dict(expand_budget=mb, pair_budget=pb, kvar=p.kvar,
               zbits=2 * p.zsize, max_per_read=p.max_zmer_freq,
               qprobe_budget=qkb)

    # ---- join matcher, full ----
    @functools.partial(jax.jit, static_argnames=())
    def run_join(r, zk, zdir, zoff, zspan, zvalid, csorted):
        pairs = extract_zmer_pairs_join(
            zk, zdir, zoff + r - r, zspan, zvalid, csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_start, read_lens_d,
            **jkw)
        return pairs.pair_id

    def join_vary(r, *xs):
        # vary: rotate query offsets by r (cheap, changes input bytes)
        return run_join(jnp.int32(r), *xs)

    timeit("join matcher (full)", join_vary, zk, zdir, zoff, zspan, zvalid,
           csorted)

    # ---- join, truncated after phase-1 expansion + row-gathers ----
    from smartdenovo_tpu.ops.dotmatrix import RM_BLK
    from smartdenovo_tpu.ops.flatops import expand_ranges

    @jax.jit
    def join_p1(r, csorted):
        c = jnp.clip(csorted, 0, n - 1)
        cvalid = (csorted >= 0) & (csorted < n)
        cstart = jnp.where(cvalid, didx.rm_start[c], 0).reshape(-1)
        asz = jnp.where(cvalid, didx.rm_start[c + 1] - didx.rm_start[c],
                        0).reshape(-1)
        NB1 = mb // RM_BLK
        bsrc, bwithin, balive, btot = expand_ranges(asz // RM_BLK, NB1)
        rows = jnp.where(balive, cstart[bsrc] // RM_BLK + bwithin, 0)
        zsd = didx.rm_zsd.reshape(-1, RM_BLK)[rows].reshape(-1)
        cpk = didx.rm_pk.reshape(-1, RM_BLK)[rows].reshape(-1)
        return zsd + cpk + r

    timeit("join p1 (expand + 3 row-gathers)", lambda r, cs: join_p1(jnp.int32(r), cs), csorted)

    # ---- join p1 + sort ----
    @jax.jit
    def join_p12(r, csorted):
        c = jnp.clip(csorted, 0, n - 1)
        cvalid = (csorted >= 0) & (csorted < n)
        cstart = jnp.where(cvalid, didx.rm_start[c], 0).reshape(-1)
        asz = jnp.where(cvalid, didx.rm_start[c + 1] - didx.rm_start[c],
                        0).reshape(-1)
        NB1 = mb // RM_BLK
        bsrc, bwithin, balive, btot = expand_ranges(asz // RM_BLK, NB1)
        rows = jnp.where(balive, cstart[bsrc] // RM_BLK + bwithin, 0)
        zsd = didx.rm_zsd.reshape(-1, RM_BLK)[rows].reshape(-1)
        cpk = didx.rm_pk.reshape(-1, RM_BLK)[rows].reshape(-1)
        src1c = jnp.broadcast_to(bsrc[:, None], (NB1, RM_BLK)).reshape(-1)
        key = (zsd ^ r).astype(jnp.int32)
        k, a, c2 = jax.lax.sort((key, cpk, src1c), num_keys=1)
        return k[::1024].sum() + a[::1024].sum()

    timeit("join p1+sort (3 arrays @ mb)", lambda r, cs: join_p12(jnp.int32(r), cs), csorted)

    # ---- dot-matrix align alone on real pairs ----
    pairs0 = run_join(jnp.int32(0), zk, zdir, zoff, zspan, zvalid, csorted)
    # rebuild full PairBatch once (kept on device)
    @jax.jit
    def mk_pairs(r):
        return extract_zmer_pairs_join(
            zk, zdir, zoff + r - r, zspan, zvalid, csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_start, read_lens_d,
            **jkw)

    PB = mk_pairs(jnp.int32(0))
    clen_of_pair = jnp.repeat(
        jnp.where(csorted < n, read_lens_d[jnp.clip(csorted, 0, n - 1)], 0)
        .astype(jnp.int32).reshape(-1), 2)
    qlen_of_pair = jnp.repeat(qlens_d.astype(jnp.int32), Adm * 2)

    live_cands = int(np.asarray((csorted < len(rb)).sum()))
    pd = Z.pad_pow2(2 * live_cands + 64, lo=1 << 12)
    print(f"live_cands={live_cands} pd={pd}", flush=True)
    dmkw = dict(n_pairs=Q * Adm * 2, nb=p.nb, xvar=p.xvar, yvar=p.yvar,
                min_block_len=p.min_block_len, max_overhang=p.max_overhang,
                deviation_penalty=p.deviation_penalty,
                gap_penalty=p.gap_penalty, nbk=nbk, pd=pd)

    @jax.jit
    def run_dm(r, PBb):
        res = dot_matrix_align(
            PBb._replace(o1l1=PBb.o1l1 + r - r), qlen_of_pair, clen_of_pair,
            **dmkw)
        return res.score

    timeit("dot_matrix_align (full)", lambda r, Pb: run_dm(jnp.int32(r), Pb), PB)

    # ---- full phase-2 chain (join + dm) as the pipeline runs it ----
    @jax.jit
    def full_p2(r):
        pairs = extract_zmer_pairs_join(
            zk, zdir, zoff + r - r, zspan, zvalid, csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_start, read_lens_d,
            **jkw)
        res = dot_matrix_align(pairs, qlen_of_pair, clen_of_pair, **dmkw)
        return res.score

    timeit("join + dot_matrix (fused jit)", lambda r: full_p2(jnp.int32(r)))

    ptot = int(np.asarray(mk_pairs(jnp.int32(0)).total))
    print(f"  true match mass (pairs.total) = {ptot} (pb={pb})", flush=True)

    out = os.path.join(ROOT, "work", "profile_zmo.json")
    with open(out, "w") as fh:
        json.dump({"batch": args.batch, "shapes": dict(
            mb=mb, pb=pb, nbk=nbk, qkb=qkb, Q=Q, Adm=Adm, Lc=Lc),
            "ms": {k: round(v * 1e3, 1) for k, v in results.items()}}, fh,
            indent=2)
    print(f"-> {out}")


if __name__ == "__main__":
    main()
