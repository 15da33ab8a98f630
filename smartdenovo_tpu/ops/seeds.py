"""Homopolymer-compressed k-mer ("zmer") seed extraction — device kernel.

Batched device replacement for the scalar scan loops in the reference
(index build wtzmo.c:249-318, per-read zmer index hzm_aln.h:70-115).
Works on padded [B, L] batches: homopolymer compaction is a masked
cumsum + scatter; rolling k-mers are k shifted OR-accumulates; canonical
strand is pure bit math (dna.h:85-97 dna_rev_seq); subsampling uses the
same Jenkins smear as the reference (wtzmo.c:35, hashset.h:452-462).

All outputs are laid out in *compressed-position space*, padded to L:
entry i corresponds to the k-mer starting at the i-th homopolymer run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

PAD = 4


def jenkins_hash_u32(key: jnp.ndarray) -> jnp.ndarray:
    """__lh3_Jenkins_hash_int (reference hashset.h:452-462) on uint32."""
    key = key.astype(jnp.uint32)
    key = key + (key << 12)
    key = key ^ (key >> 22)
    key = key + (key << 4)
    key = key ^ (key >> 9)
    key = key + (key << 10)
    key = key ^ (key >> 2)
    key = key + (key << 7)
    key = key ^ (key >> 12)
    return key


def revcomp_kmer_u32(kmer: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Reverse-complement of a 2-bit packed k-mer (k <= 16) in uint32.

    Same bit-twiddle as dna.h:85-97 restricted to 32 bits.
    """
    x = (~kmer).astype(jnp.uint32)
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x & jnp.uint32(0xCCCCCCCC)) >> 2)
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x & jnp.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x & jnp.uint32(0xFF00FF00)) >> 8)
    x = (x << 16) | (x >> 16)
    return x >> (32 - (ksize << 1))


@functools.partial(jax.jit, static_argnames=("ksize", "hz"))
def extract_seeds(batch: jnp.ndarray, lengths: jnp.ndarray, ksize: int, hz: bool = True):
    """Extract canonical hpc k-mers from a padded [B, L] base batch.

    Returns a dict of [B, L] arrays in compressed-position space:
      kmer  uint32  canonical k-mer code
      dir   bool    True if the canonical form is the reverse complement
      off   int32   raw-space start position (first base of first run)
      span  int32   raw-space covered length (through first base of last run,
                    matching hzm_aln.h:101-103 / wtzmo index len semantics)
      valid bool    k-mer exists (within read, non-palindromic)
    plus 'n_comp' [B] int32, the compressed length per read.
    """
    B, L = batch.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    inbounds = pos < lengths[:, None]
    base = batch.astype(jnp.int32)
    if hz:
        prev = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), base[:, :-1]], axis=1)
        keep = inbounds & (base != prev)
    else:
        keep = inbounds
    comp_idx = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    n_comp = comp_idx[:, -1] + 1
    scatter_idx = jnp.where(keep, comp_idx, L)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, L))
    # compressed base codes and raw offsets of each run start
    comp_seq = (
        jnp.zeros((B, L + 1), jnp.int32).at[rows, scatter_idx].set(base, mode="drop")[:, :L]
    )
    hzoff = (
        jnp.zeros((B, L + 1), jnp.int32).at[rows, scatter_idx].set(pos, mode="drop")[:, :L]
    )
    # rolling k-mer codes: kmer[i] packs comp_seq[i..i+k) MSB-first
    kmer = jnp.zeros((B, L), jnp.uint32)
    for t in range(ksize):
        shifted = jnp.concatenate(
            [comp_seq[:, t:], jnp.zeros((B, t), jnp.int32)], axis=1
        )
        kmer = (kmer << 2) | shifted.astype(jnp.uint32)
    krev = revcomp_kmer_u32(kmer, ksize)
    direction = krev <= kmer  # dir=1 when canonical is revcomp (krev<kmer); == is palindromic
    canon = jnp.minimum(kmer, krev)
    comp_pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    exists = comp_pos + ksize <= n_comp[:, None]
    palin = krev == kmer
    valid = exists & ~palin
    off = hzoff
    last_run = jnp.concatenate(
        [hzoff[:, ksize - 1 :], jnp.zeros((B, ksize - 1), jnp.int32)], axis=1
    )
    span = jnp.where(valid, last_run + 1 - off, 0)
    return {
        "kmer": jnp.where(valid, canon, jnp.uint32(0xFFFFFFFF)),
        "dir": direction & valid,
        "off": off,
        "span": span,
        "valid": valid,
        "n_comp": n_comp,
    }


def subsample_mask(kmer: jnp.ndarray, ksave: int, kmer_mod: int = 1024) -> jnp.ndarray:
    """Deterministic 1/ksave k-mer subsampling (wtzmo.c:270-271).

    Keeps a k-mer iff jenkins(kmer) % (kmer_mod * ksave) < kmer_mod.
    """
    if ksave <= 1:
        return jnp.ones(kmer.shape, bool)
    h = jenkins_hash_u32(kmer) % jnp.uint32(kmer_mod * ksave)
    return h < jnp.uint32(kmer_mod)


# ---------------------------------------------------------------------------
# Pure-numpy oracle used by the test-suite to validate the device kernel.
# Mirrors the reference scan loop structure directly (wtzmo.c:255-276).
# ---------------------------------------------------------------------------


def extract_seeds_np(seq, ksize: int, hz: bool = True):
    import numpy as np

    mask = (1 << (2 * ksize)) - 1
    kmer = 0
    b = -1
    hzoff = []
    out = []
    i = 0
    for j, c in enumerate(seq):
        c = int(c)
        if hz and c == b:
            continue
        b = c
        i += 1
        hzoff.append(j)
        kmer = ((kmer << 2) | c) & mask
        if i < ksize:
            continue
        # revcomp
        rc = 0
        t = kmer
        for _ in range(ksize):
            rc = (rc << 2) | (3 - (t & 3))
            t >>= 2
        if rc == kmer:
            continue
        d = 0 if rc > kmer else 1
        canon = min(kmer, rc)
        off = hzoff[i - ksize]
        out.append((canon, d, off, j + 1 - off))
    return out


def np_canonical_kmers(batch, lengths, ksize: int, hz: bool = True):
    """Numpy twin of extract_seeds returning only (codes, valid) — used by
    the host to size expansion budgets exactly without a device sync."""
    import numpy as np

    B, L = batch.shape
    base = batch.astype(np.int64)
    pos = np.arange(L)[None, :]
    inb = pos < lengths[:, None]
    if hz:
        prev = np.concatenate([np.full((B, 1), -1), base[:, :-1]], axis=1)
        keep = inb & (base != prev)
    else:
        keep = inb
    comp_idx = np.cumsum(keep, axis=1) - 1
    n_comp = comp_idx[:, -1] + 1
    comp = np.zeros((B, L + 1), np.int64)
    rows = np.broadcast_to(np.arange(B)[:, None], (B, L))
    sidx = np.where(keep, comp_idx, L)
    comp[rows, sidx] = base
    comp = comp[:, :L]
    kmer = np.zeros((B, L), np.uint64)
    for t in range(ksize):
        shifted = np.concatenate([comp[:, t:], np.zeros((B, t), np.int64)], axis=1)
        kmer = (kmer << np.uint64(2)) | shifted.astype(np.uint64)
    mask = np.uint64((1 << (2 * ksize)) - 1)
    kmer &= mask
    # revcomp via bit ops
    x = (~kmer) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | ((x & np.uint64(0xCCCCCCCCCCCCCCCC)) >> np.uint64(2))
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | ((x & np.uint64(0xF0F0F0F0F0F0F0F0)) >> np.uint64(4))
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | ((x & np.uint64(0xFF00FF00FF00FF00)) >> np.uint64(8))
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | ((x & np.uint64(0xFFFF0000FFFF0000)) >> np.uint64(16))
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    rc = x >> np.uint64(64 - 2 * ksize)
    canon = np.minimum(kmer, rc)  # uint64: supports k>16 (DBG correction)
    cpos = np.arange(L)[None, :]
    valid = (cpos + ksize <= n_comp[:, None]) & (kmer != rc)
    return canon, valid


def np_jenkins_u32(key):
    """Numpy twin of jenkins_hash_u32."""
    import numpy as np

    key = key.astype(np.uint32)
    key = key + (key << np.uint32(12))
    key ^= key >> np.uint32(22)
    key = key + (key << np.uint32(4))
    key ^= key >> np.uint32(9)
    key = key + (key << np.uint32(10))
    key ^= key >> np.uint32(2)
    key = key + (key << np.uint32(7))
    key ^= key >> np.uint32(12)
    return key


@functools.partial(jax.jit, static_argnames=("ksize", "hz", "ksave", "with_pos"))
def compact_seed_batch(batch, lengths, rids, ksize: int, hz: bool = True,
                       ksave: int = 0, with_pos: bool = False):
    """Extract seeds and compact the valid ones to the front of flat arrays.

    Index builds fetch seeds to the host; the dense [B, L] layout is ~90%
    padding, so compaction happens on device and callers transfer only
    [:total].

    Returns (kmer [B*L] uint32, aux [B*L] int32, total) where aux packs
    rd<<1|dir (with_pos=False) or off<<9|span<<1|dir (with_pos=True, rd
    returned as a third array).
    """
    res = extract_seeds(batch, lengths, ksize, hz)
    valid = res["valid"]
    if ksave > 1:
        valid = valid & subsample_mask(res["kmer"], ksave)
    B, L = valid.shape
    N = B * L
    v = valid.reshape(-1)
    dst = jnp.cumsum(v.astype(jnp.int32)) - 1
    total = dst[-1] + 1
    dst = jnp.where(v, dst, N)

    def scat(vals, dtype=jnp.int32):
        return (
            jnp.zeros(N + 1, dtype)
            .at[dst]
            .set(vals.reshape(-1).astype(dtype), mode="drop")[:N]
        )

    rd_of = jnp.broadcast_to(rids[:, None].astype(jnp.int32), (B, L))
    d = res["dir"].astype(jnp.int32)
    kc = scat(res["kmer"], jnp.uint32)
    if with_pos:
        aux = (res["off"].astype(jnp.int32) << 9) | (
            jnp.minimum(res["span"], 255).astype(jnp.int32) << 1) | d
        return kc, scat(aux), scat(rd_of), total
    aux = (rd_of << 1) | d
    return kc, scat(aux), total
