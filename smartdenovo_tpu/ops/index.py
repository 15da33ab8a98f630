"""Global sorted k-mer / z-mer posting indexes (device-resident).

Device-resident replacement for the reference's 1024-way hash-table k-mer index
(wtzmo.c:227-430) and the per-read zmer hash (hzm_aln.h:70-115).  Instead of
hash tables we keep one flat posting array sorted by (kmer, read, dir);
queries are vectorised binary searches.  This layout is what the sharded
multi-host design partitions by kmer hash range (cf. SURVEY.md §5.8).

The k-mer index (k=16, homopolymer-compressed, 1/ksave Jenkins-subsampled,
frequency-filtered) drives candidate selection.  The z-mer index (z=10,
no subsampling, per-read occurrence cap) drives seed-pair generation for
the dot-matrix / banded aligners; its postings carry raw offsets + spans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..data.readbank import ReadBank
from ..utils.log import log
from .seeds import extract_seeds, subsample_mask, compact_seed_batch


def _length_batches(rb: ReadBank, target_elems: int = 1 << 24):
    """Yield (rids, padded_len) batches; reads are length-sorted desc.

    Lengths pad to power-of-two tiers and batch sizes are fixed per tier so
    each (B, L) shape compiles exactly once.
    """
    n = len(rb)
    i = 0
    while i < n:
        L = max(2048, int(rb.lengths[i]))
        Lp = 1 << (L - 1).bit_length()
        bsz = max(1, target_elems // Lp)
        yield np.arange(i, min(n, i + bsz)), Lp
        i += bsz


def _pad_rids(rids: np.ndarray, _bsz_unused: int = 0):
    """Pad a partial batch to a power-of-two size with masked repeats, so
    batch shapes stay within a small (log B x log L) compile set."""
    bsz = 1 << max(0, (len(rids) - 1)).bit_length()
    bsz = max(1, bsz)
    mask = np.zeros(bsz, np.int32)
    mask[: len(rids)] = 1
    if len(rids) < bsz:
        rids = np.concatenate([rids, np.full(bsz - len(rids), rids[0], rids.dtype)])
    return rids, mask


@dataclasses.dataclass
class KmerIndex:
    """Sorted canonical-kmer postings for candidate selection."""

    kmers: jnp.ndarray  # [P] uint32, sorted
    post_rd: jnp.ndarray  # [P] int32
    post_dir: jnp.ndarray  # [P] int8
    max_freq: int
    ksize: int
    n_reads: int
    np_kmers: "np.ndarray" = None  # host copy for budget sizing

    @property
    def n_postings(self) -> int:
        return int(self.kmers.shape[0])


def build_kmer_index(
    rb: ReadBank,
    ksize: int = 16,
    hz: bool = True,
    ksave: int = 4,
    max_freq: int = 0,
    batch_elems: int = 1 << 24,
) -> KmerIndex:
    """Build the candidate k-mer index.

    Frequency cutoff semantics follow wtzmo.c:380-418: if max_freq < 2 it is
    set to 5x the average depth of distinct kmers (min 100); kmers above the
    cutoff or occurring once are dropped entirely.
    """
    ks, rds, dirs = [], [], []
    for rids, Lp in _length_batches(rb, batch_elems):
        rids, lens_mask = _pad_rids(rids, batch_elems // Lp)
        batch, lens = rb.batch(rids, pad_to=Lp)
        lens = lens * lens_mask
        kc, aux, total = compact_seed_batch(
            jnp.asarray(batch), jnp.asarray(lens), jnp.asarray(rids, jnp.int32),
            ksize, hz, ksave)
        t = int(total)  # transfer only the live prefix
        km = np.asarray(kc[:t])
        ax = np.asarray(aux[:t])
        ks.append(km)
        rds.append((ax >> 1).astype(np.int32))
        dirs.append((ax & 1).astype(np.int8))
    kmers = np.concatenate(ks) if ks else np.zeros(0, np.uint32)
    post_rd = np.concatenate(rds) if rds else np.zeros(0, np.int32)
    post_dir = np.concatenate(dirs) if dirs else np.zeros(0, np.int8)
    # sort by (kmer, rd, dir) — one packed uint64 key
    key = (kmers.astype(np.uint64) << np.uint64(32)) | (
        (post_rd.astype(np.uint64) << np.uint64(1)) | post_dir.astype(np.uint64)
    )
    order = np.argsort(key, kind="stable")
    kmers, post_rd, post_dir = kmers[order], post_rd[order], post_dir[order]
    # run-length stats over distinct kmers
    if len(kmers):
        boundary = np.empty(len(kmers), bool)
        boundary[0] = True
        np.not_equal(kmers[1:], kmers[:-1], out=boundary[1:])
        seg_id = np.cumsum(boundary) - 1
        cnt = np.bincount(seg_id)
        kavg = max(20, int(len(kmers) // max(1, len(cnt))))
        if max_freq < 2:
            max_freq = kavg * 5
            log("high frequency kmer cutoff set to %d", max_freq)
        per_post_cnt = cnt[seg_id]
        keep = (per_post_cnt > 1) & (per_post_cnt <= max_freq)
        n_flt = int((cnt > max_freq).sum())
        log(
            "kmer index: %d postings, %d distinct, avg depth %d, %d high-freq filtered",
            len(kmers), len(cnt), len(kmers) // max(1, len(cnt)), n_flt,
        )
        kmers, post_rd, post_dir = kmers[keep], post_rd[keep], post_dir[keep]
    else:
        max_freq = max(max_freq, 100)
    return KmerIndex(
        kmers=jnp.asarray(kmers),
        post_rd=jnp.asarray(post_rd),
        post_dir=jnp.asarray(post_dir),
        max_freq=max_freq,
        ksize=ksize,
        n_reads=len(rb),
        np_kmers=kmers,
    )


@dataclasses.dataclass
class ZmerIndex:
    """Sorted zmer postings with offsets/spans for seed-pair generation."""

    zmers: jnp.ndarray  # [P] uint32, sorted by (zmer, rd)
    post_rd: jnp.ndarray  # [P] int32
    post_dir: jnp.ndarray  # [P] int8
    post_off: jnp.ndarray  # [P] int32 raw offset in read
    post_span: jnp.ndarray  # [P] int32 raw covered length
    post_packed: jnp.ndarray = None  # [P] int32 = off<<9 | min(span,255)<<1 | dir
    zsize: int = 10
    max_per_read: int = 16
    np_zmers: "np.ndarray" = None     # host copy for budget sizing
    np_key: "np.ndarray" = None       # host packed (zmer<<32)|rd
    # read-major view for the sort-join matcher (extract_zmer_pairs_join)
    rm_zsd: jnp.ndarray = None       # [P] int32 zmer<<9|span<<1|dir, read-major
    rm_pk: jnp.ndarray = None        # [P] int32 off<<9|span<<1|dir, read-major
    rm_start: jnp.ndarray = None     # [R+1] int32 CSR offsets per read
    max_read_z: int = 0              # max postings of any single read
    np_top_z: "np.ndarray" = None    # read z-counts sorted desc (budget bound)


def build_zmer_index(
    rb: ReadBank,
    zsize: int = 10,
    hz: bool = True,
    max_per_read: int = 16,
    batch_elems: int = 1 << 24,
) -> ZmerIndex:
    """Build the z-mer index.

    Per-read occurrence cap mirrors index_single_read_seeds
    (hzm_aln.h:107 `kcnt < max_kcnt`): (read, zmer) groups with >= cap
    occurrences are dropped entirely.
    """
    zs, rds, dirs, offs, spans = [], [], [], [], []
    for rids, Lp in _length_batches(rb, batch_elems):
        rids, lens_mask = _pad_rids(rids, batch_elems // Lp)
        batch, lens = rb.batch(rids, pad_to=Lp)
        lens = lens * lens_mask
        kc, aux, rdc, total = compact_seed_batch(
            jnp.asarray(batch), jnp.asarray(lens), jnp.asarray(rids, jnp.int32),
            zsize, hz, 0, with_pos=True)
        t = int(total)  # transfer only the live prefix
        ax = np.asarray(aux[:t])
        zs.append(np.asarray(kc[:t]))
        dirs.append((ax & 1).astype(np.int8))
        offs.append((ax >> 9).astype(np.int32))
        spans.append(((ax >> 1) & 0xFF).astype(np.int32))
        rds.append(np.asarray(rdc[:t]))
    zmers = np.concatenate(zs) if zs else np.zeros(0, np.uint32)
    post_rd = np.concatenate(rds) if rds else np.zeros(0, np.int32)
    post_dir = np.concatenate(dirs) if dirs else np.zeros(0, np.int8)
    post_off = np.concatenate(offs) if offs else np.zeros(0, np.int32)
    post_span = np.concatenate(spans) if spans else np.zeros(0, np.int32)
    key = (zmers.astype(np.uint64) << np.uint64(32)) | post_rd.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    zmers, post_rd, post_dir, post_off, post_span = (
        zmers[order], post_rd[order], post_dir[order], post_off[order], post_span[order]
    )
    if len(zmers):
        grp = np.empty(len(zmers), bool)
        grp[0] = True
        np.not_equal(key[order][1:], key[order][:-1], out=grp[1:])
        gid = np.cumsum(grp) - 1
        gcnt = np.bincount(gid)
        keep = gcnt[gid] < max_per_read
        log(
            "zmer index: %d postings, %d (read,zmer) groups, %d dropped by per-read cap",
            len(zmers), len(gcnt), int((~keep).sum()),
        )
        zmers, post_rd, post_dir, post_off, post_span = (
            zmers[keep], post_rd[keep], post_dir[keep], post_off[keep], post_span[keep]
        )
    packed = (
        (post_off.astype(np.int64) << 9)
        | (np.minimum(post_span, 255).astype(np.int64) << 1)
        | post_dir.astype(np.int64)
    ).astype(np.int32)
    # read-major copy: per-read posting slices for per-pair intersection
    rmo = np.argsort(
        (post_rd.astype(np.uint64) << np.uint64(32)) | zmers.astype(np.uint64),
        kind="stable",
    )
    rm_zsd = (
        (zmers[rmo].astype(np.int64) << 9)
        | (np.minimum(post_span[rmo], 255).astype(np.int64) << 1)
        | post_dir[rmo].astype(np.int64)
    ).astype(np.int32)
    rm_pk = packed[rmo]
    percnt = np.bincount(post_rd, minlength=len(rb)).astype(np.int32)
    rm_start = np.concatenate([[0], np.cumsum(percnt)]).astype(np.int32)
    return ZmerIndex(
        zmers=jnp.asarray(zmers),
        post_rd=jnp.asarray(post_rd),
        post_dir=jnp.asarray(post_dir),
        post_off=jnp.asarray(post_off),
        post_span=jnp.asarray(post_span),
        post_packed=jnp.asarray(packed),
        zsize=zsize,
        max_per_read=max_per_read,
        np_zmers=zmers,
        np_key=(zmers.astype(np.uint64) << np.uint64(32)) | post_rd.astype(np.uint64),
        rm_zsd=jnp.asarray(rm_zsd),
        rm_pk=jnp.asarray(rm_pk),
        rm_start=jnp.asarray(rm_start),
        max_read_z=int(percnt.max()) if len(percnt) else 0,
        np_top_z=np.sort(percnt)[::-1].copy(),
    )
