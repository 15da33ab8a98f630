"""Whole-bank flat seed extraction + device-resident index build.

The round-1 pipeline extracted seeds per padded [B, L] read batch and
round-tripped postings through the host to sort them (ops/index.py), so
it spent its time on host syncs and transfers.  Here the WHOLE
read bank is processed as one flat [T] array (reference BaseBank layout,
dna.h): homopolymer compaction, rolling k-mers, canonicalisation and
validity are 1-D masked scans — no per-read padding, one compile per
dataset size tier, zero host round-trips.  Index sorting and frequency
filtering (reference wtzmo.c:227-430 two-pass hash build; per-read zmer
cap hzm_aln.h:107) run on device; the host fetches one small stats pack.

Layouts (all live-prefix arrays padded to the [T] tier):
  compressed position space: j-th homopolymer run of the bank, reads
  back-to-back.  comp_start [Npad+1] CSR gives each read's slice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .seeds import revcomp_kmer_u32, jenkins_hash_u32, subsample_mask

SENT_U32 = jnp.uint32(0xFFFFFFFF)


def pad_pow2(n: int, lo: int = 1 << 12) -> int:
    """Pad to quarter-power-of-two tiers (1, 1.25, 1.5, 1.75 x pow2).

    Budget widths set the cost of every budget-wide sort/scan/scatter, so
    plain pow2 tiers overshoot true masses by up to 2x (measured 1.78x on
    the bench set).  Quarter tiers cap the overshoot at 1.25x while still
    keeping the distinct-shape count (and hence XLA compiles, disk-cached)
    small.  Tiers stay multiples of pow2(n)/4 >= lo/4, preserving the
    128/1024 alignment the matchers require for lo >= 4096 (and
    128-alignment for lo >= 512)."""
    n = max(n, lo)
    p = 1 << (n - 1).bit_length()       # pow2 ceiling
    # quarter tiers of the pow2 FLOOR (= p/8): 1, 1.25, 1.5, 1.75 x pow2.
    # p//4 here overshot by up to 1.5x (it only produced 1.0/1.5x tiers).
    # Floor of 128 keeps every tier 128-aligned for the matcher kernels.
    step = max(p // 8, 128)
    return (n + step - 1) // step * step


class FlatSeeds(NamedTuple):
    kmer: jnp.ndarray      # [T] uint32 canonical code (SENT where invalid)
    aux: jnp.ndarray       # [T] int32 off<<9 | min(span,255)<<1 | dir
    valid: jnp.ndarray     # [T] bool
    comp_rd: jnp.ndarray   # [T] int32 read id of compressed position
    comp_start: jnp.ndarray  # [Npad+1] int32 per-read compressed CSR
    total: jnp.ndarray     # scalar int32 total compressed positions


@functools.partial(jax.jit, static_argnames=("ksize", "hz"))
def flat_seeds(flat: jnp.ndarray, offsets: jnp.ndarray, ksize: int,
               hz: bool = True) -> FlatSeeds:
    """Extract canonical hpc k-mers for every read of the bank at once.

    flat:    [T] uint8 base codes (PAD=4 beyond the live prefix)
    offsets: [Npad+1] int32 read start offsets (trailing entries = total)
    """
    T = flat.shape[0]
    pos = jnp.arange(T, dtype=jnp.int32)
    # read id per raw position: +1 at every read start (duplicated trailing
    # offsets accumulate in the pad zone, pushing pad rd past n — harmless)
    mark = jnp.zeros(T + 1, jnp.int32).at[offsets[1:]].add(1, mode="drop")[:T]
    rd_of = jnp.cumsum(mark)
    base = flat.astype(jnp.int32)
    inb = base < 4
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), base[:-1]])
    new_read = jnp.concatenate([jnp.ones((1,), bool), rd_of[1:] != rd_of[:-1]])
    if hz:
        keep = inb & ((base != prev) | new_read)
    else:
        keep = inb
    cidx = jnp.cumsum(keep.astype(jnp.int32)) - 1
    total = cidx[-1] + 1
    dst = jnp.where(keep, cidx, T)

    def scat(vals, dtype=jnp.int32):
        return jnp.zeros(T + 1, dtype).at[dst].set(vals.astype(dtype), mode="drop")[:T]

    comp_seq = scat(base)
    comp_raw = scat(pos)            # raw position of each run start
    Npad0 = offsets.shape[0] - 1
    comp_rd = jnp.where(
        jnp.arange(T, dtype=jnp.int32) < total, scat(rd_of), Npad0
    )
    # per-read compressed counts -> CSR
    Npad = Npad0
    ccnt = jax.ops.segment_sum(keep.astype(jnp.int32), rd_of, num_segments=Npad)
    comp_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(ccnt).astype(jnp.int32)]
    )
    # rolling k-mers over the compressed sequence
    kmer = jnp.zeros(T, jnp.uint32)
    for t in range(ksize):
        shifted = jnp.concatenate([comp_seq[t:], jnp.zeros((t,), jnp.int32)])
        kmer = (kmer << 2) | shifted.astype(jnp.uint32)
    krev = revcomp_kmer_u32(kmer, ksize)
    direction = krev <= kmer
    canon = jnp.minimum(kmer, krev)
    cpos = jnp.arange(T, dtype=jnp.int32)
    last = jnp.clip(cpos + ksize - 1, 0, T - 1)
    same_read = (comp_rd[last] == comp_rd) & (cpos + ksize - 1 < T)
    exists = (cpos < total) & same_read
    valid = exists & (krev != kmer)
    read_beg = offsets[jnp.clip(comp_rd, 0, Npad - 1)]
    off = comp_raw - read_beg
    span = comp_raw[last] + 1 - comp_raw
    aux = jnp.where(
        valid,
        (off << 9) | (jnp.minimum(span, 255) << 1) | direction.astype(jnp.int32),
        0,
    )
    return FlatSeeds(
        kmer=jnp.where(valid, canon, SENT_U32),
        aux=aux,
        valid=valid,
        comp_rd=jnp.where(cpos < total, comp_rd, Npad),
        comp_start=comp_start,
        total=total,
    )


RM_BLK = 128  # read-major slice alignment, so matcher expansion becomes
              # row-gathers of [P/128, 128] tables instead of element
              # gathers


class DeviceIndexes(NamedTuple):
    """Both overlap indexes + stats, built in one jit call."""

    # k16 candidate index, sorted by (kmer, rd, dir), sentinel-padded
    k_kmers: jnp.ndarray   # [T] uint32
    k_rd: jnp.ndarray      # [T] int32
    k_dir: jnp.ndarray     # [T] int8
    # z10 read-major index for the sort-join / sweep matchers; every read's
    # slice starts at a RM_BLK multiple (gap entries carry sentinel zsd)
    rm_zsd: jnp.ndarray    # [Tz] int32 zmer<<9|span<<1|dir, (rd, zmer) sorted
    rm_pk: jnp.ndarray     # [Tz] int32 off<<9|span<<1|dir
    rm_rd: jnp.ndarray     # [Tz] int32 read id per posting (sweep matcher)
    rm_start: jnp.ndarray  # [Npad+1] int32 ALIGNED CSR (RM_BLK multiples)
    rm_cnt: jnp.ndarray    # [Npad] int32 live postings per read
    # stats pack (host fetches this one small array):
    # [0:n]=per-read z-counts, [n:2n]=per-read k16 expansion need,
    # [2n:3n]=per-read live k16 probe counts, [3n:4n]=per-read compressed
    # lengths, [4n:5n]=per-read cross mass (sum of global zmer freq over
    # the read's kept postings — exact sweep-matcher budget),
    # [5n]=max comp len, [5n+1]=k16 max_freq used, [5n+2]=total k
    # postings, [5n+3]=average kmer depth (~coverage estimate)
    stats: jnp.ndarray     # [5*Npad+4] int32


@functools.partial(jax.jit, static_argnames=("max_kmer_freq", "max_zmer_freq",
                                             "ksave", "zbits"))
def build_indexes_device(
    k16: FlatSeeds,
    z10: FlatSeeds,
    read_lens: jnp.ndarray = None,   # [R] int32 raw lengths (rm_fo table)
    *,
    ksave: int = 4,
    max_kmer_freq: int = 0,
    max_zmer_freq: int = 16,
    zbits: int = 20,       # 2*zsize (zmer value space; zsize <= 12)
) -> DeviceIndexes:
    """Sort + filter both posting indexes on device (no host round trips).

    k16 semantics follow wtzmo.c:380-418: auto cutoff = 5x average depth of
    distinct kmers when max_kmer_freq < 2; singleton and high-freq kmers
    dropped.  z10 semantics follow hzm_aln.h:107: (read, zmer) groups with
    >= max_zmer_freq occurrences dropped entirely.
    """
    T = k16.kmer.shape[0]
    Npad = k16.comp_start.shape[0] - 1
    # ---- k16 candidate index ----------------------------------------
    kval = k16.valid & subsample_mask(k16.kmer, ksave)
    kk = jnp.where(kval, k16.kmer, SENT_U32)
    krdpk = (k16.comp_rd << 1) | (k16.aux & 1)
    kk, krdpk = jax.lax.sort((kk, krdpk), num_keys=1)
    live = kk != SENT_U32
    n_post = jnp.sum(live.astype(jnp.int32))
    new = jnp.concatenate([jnp.ones(1, bool), kk[1:] != kk[:-1]]) & live
    gid = jnp.cumsum(new.astype(jnp.int32)) - 1
    n_distinct = jnp.maximum(gid[-1] + 1, 1)
    freq = jax.ops.segment_sum(live.astype(jnp.int32), jnp.where(live, gid, T),
                               num_segments=T + 1)[:T]
    myfreq = freq[jnp.clip(gid, 0, T - 1)]
    kavg = jnp.maximum(n_post // n_distinct, 20)
    cutoff = (jnp.int32(max_kmer_freq) if max_kmer_freq >= 2
              else jnp.maximum(kavg * 5, 100))
    keepk = live & (myfreq > 1) & (myfreq <= cutoff)
    # stable compaction of survivors (already kmer-sorted): two sorted
    # scatters replace the round-3 full re-sort
    kdst = jnp.where(keepk, jnp.cumsum(keepk.astype(jnp.int32)) - 1, T)
    kk2 = (jnp.full(T + 1, SENT_U32, jnp.uint32)
           .at[kdst].set(kk, mode="drop")[:T])
    krdpk2 = (jnp.zeros(T + 1, jnp.int32)
              .at[kdst].set(krdpk, mode="drop")[:T])
    k_rd = krdpk2 >> 1
    # per-read expansion need: total frequency of the read's surviving,
    # sampled kmers (drives the candidate-scan budget exactly)
    myfreq2 = jnp.where(keepk, myfreq, 0)
    kneed = jax.ops.segment_sum(myfreq2, jnp.where(keepk, krdpk >> 1, Npad),
                                num_segments=Npad + 1)[:Npad]
    # ---- z10 read-major index ---------------------------------------
    zz = z10.kmer
    zval = z10.valid
    # read-major sort by (rd, zmer): pack into one int64-free key pair
    zkey1 = jnp.where(zval, z10.comp_rd, jnp.int32(Npad + 1))
    zkey2 = jnp.where(zval, zz.astype(jnp.int32), jnp.int32(0x7FFFFFFF))
    zk1, zk2, zaux = jax.lax.sort((zkey1, zkey2, z10.aux), num_keys=2)
    zlive = zk1 <= Npad
    gnew = jnp.concatenate(
        [jnp.ones(1, bool), (zk1[1:] != zk1[:-1]) | (zk2[1:] != zk2[:-1])]
    ) & zlive
    zgid = jnp.cumsum(gnew.astype(jnp.int32)) - 1
    gcnt = jax.ops.segment_sum(zlive.astype(jnp.int32), jnp.where(zlive, zgid, T),
                               num_segments=T + 1)[:T]
    mycnt = gcnt[jnp.clip(zgid, 0, T - 1)]
    keepz = zlive & (mycnt < max_zmer_freq)
    zrd = jnp.where(keepz, zk1, Npad)
    zcnt_per_rd = jax.ops.segment_sum(keepz.astype(jnp.int32), zrd,
                                      num_segments=Npad + 1)[:Npad]
    # aligned placement: each read's slice starts at a RM_BLK multiple so
    # the matchers can row-gather [RM_BLK]-wide tiles instead of paying an
    # element gather per posting; gap entries carry a sentinel zsd
    asz = (zcnt_per_rd + (RM_BLK - 1)) // RM_BLK * RM_BLK
    rm_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(asz).astype(jnp.int32)]
    )
    lstart = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(zcnt_per_rd).astype(jnp.int32)]
    )
    Tz = T + Npad * RM_BLK
    shift = rm_start[:-1] - lstart[:-1]                 # [Npad] >= 0
    zdst = jnp.cumsum(keepz.astype(jnp.int32)) - 1      # live rank
    zdst = jnp.where(keepz, zdst + shift[jnp.clip(zrd, 0, Npad - 1)], Tz)
    SENT_ZSD = jnp.int32(1 << (zbits + 9))              # (zmer==ZS) << 9

    def zscat(vals, fill=0):
        return jnp.full(Tz + 1, fill, jnp.int32).at[zdst].set(
            vals.astype(jnp.int32), mode="drop")[:Tz]

    rm_zsd = zscat((zk2 << 9) | ((zaux & 0x1FF) >> 1 << 1) | (zaux & 1),
                   fill=SENT_ZSD)
    rm_pk = zscat(zaux)
    rm_rd = zscat(zk1, fill=Npad)
    # global zmer frequency (direct-addressed, zsize <= 12) -> per-read
    # cross mass: SUM over the read's kept postings of the global freq of
    # that zmer == the sweep matcher's exact expansion size for the read
    zspace = 1 << zbits
    zfreq = jnp.zeros(zspace + 1, jnp.int32).at[
        jnp.where(keepz, jnp.minimum(zk2, zspace), zspace)
    ].add(1, mode="drop")
    gfreq = jnp.where(keepz, zfreq[jnp.clip(zk2, 0, zspace)], 0)
    cross_per_rd = jax.ops.segment_sum(gfreq, zrd, num_segments=Npad + 1)[:Npad]
    comp_len = k16.comp_start[1:] - k16.comp_start[:-1]
    kprobes = jax.ops.segment_sum(
        kval.astype(jnp.int32), k16.comp_rd, num_segments=Npad + 1)[:Npad]
    stats = jnp.concatenate([
        zcnt_per_rd,
        kneed,
        kprobes,
        comp_len,
        cross_per_rd,
        jnp.stack([jnp.max(comp_len), cutoff.astype(jnp.int32),
                   n_post.astype(jnp.int32),
                   # distinct KEPT kmers ~ genome_size(compressed)/ksave:
                   # the host derives a coverage estimate as
                   # sum(comp_len) / (distinct_kept * ksave) — kmer
                   # FREQUENCY cannot estimate coverage at high error
                   # (observed depth ~ coverage * (1-err)^k)
                   jnp.sum((new & keepk).astype(jnp.int32))]),
    ])
    return DeviceIndexes(
        k_kmers=kk2, k_rd=k_rd, k_dir=(krdpk2 & 1).astype(jnp.int8),
        rm_zsd=rm_zsd, rm_pk=rm_pk, rm_rd=rm_rd,
        rm_start=rm_start, rm_cnt=zcnt_per_rd,
        stats=stats,
    )


@functools.partial(jax.jit, static_argnames=(
    "ksize", "zsize", "hz", "ksave", "max_kmer_freq", "max_zmer_freq",
    "zbits"))
def build_bank_indexes(flat, offsets, read_lens, *, ksize: int, zsize: int,
                       hz: bool = True, ksave: int = 4,
                       max_kmer_freq: int = 0, max_zmer_freq: int = 16,
                       zbits: int = 20):
    """Both seed extractions + the index build in ONE dispatch.

    The k-mer and z-mer extractions share the identical homopolymer
    compaction; tracing them inside one jit lets XLA CSE it (separate
    dispatches each paid it)."""
    k16 = flat_seeds.__wrapped__(flat, offsets, ksize, hz)
    z10 = flat_seeds.__wrapped__(flat, offsets, zsize, hz)
    didx = build_indexes_device.__wrapped__(
        k16, z10, read_lens, ksave=ksave, max_kmer_freq=max_kmer_freq,
        max_zmer_freq=max_zmer_freq, zbits=zbits)
    return k16, z10, didx


@functools.partial(jax.jit, static_argnames=("Lc",))
def gather_query_rows(seeds: FlatSeeds, rids: jnp.ndarray, Lc: int):
    """Materialise [Q, Lc] query seed rows from the flat arrays.

    Returns (kmer, off, span, dir, valid) in per-read compressed-position
    space — the layout scan_candidates / extract_zmer_pairs_join expect.
    """
    Npad = seeds.comp_start.shape[0] - 1
    r = jnp.clip(rids, 0, Npad - 1)
    base = seeds.comp_start[r]
    cnt = seeds.comp_start[r + 1] - base
    j = jnp.arange(Lc, dtype=jnp.int32)[None, :]
    idx = jnp.clip(base[:, None] + j, 0, seeds.kmer.shape[0] - 1)
    inrow = j < cnt[:, None]
    kmer = jnp.where(inrow, seeds.kmer[idx], SENT_U32)
    aux = jnp.where(inrow, seeds.aux[idx], 0)
    valid = inrow & seeds.valid[idx]
    return (kmer, aux >> 9, (aux >> 1) & 0xFF, (aux & 1).astype(bool), valid)
