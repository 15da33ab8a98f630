import pytest
import numpy as np
import jax.numpy as jnp

from smartdenovo_tpu.data.readbank import ReadBank
from smartdenovo_tpu.ops.index import build_kmer_index, build_zmer_index
from smartdenovo_tpu.ops.seeds import extract_seeds, subsample_mask
from smartdenovo_tpu.ops.candidates import scan_candidates
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads


def _bank(seed=3, glen=20000, cov=8, err=0.12):
    rng = np.random.default_rng(seed)
    g = random_genome(rng, glen)
    names, seqs = simulate_reads(g, coverage=cov, mean_len=4000, err=err, seed=seed + 1)
    return g, ReadBank(names, seqs)


def _query_arrays(rb, rids, ksize=16, ksave=4):
    batch, lens = rb.batch(np.asarray(rids))
    res = extract_seeds(jnp.asarray(batch), jnp.asarray(lens), ksize, True)
    valid = res["valid"] & subsample_mask(res["kmer"], ksave)
    return res, valid, lens


def test_candidates_find_true_overlaps():
    g, rb = _bank()
    idx = build_kmer_index(rb, ksize=16, ksave=4)
    Q = min(8, len(rb))
    rids = np.arange(Q)
    res, valid, lens = _query_arrays(rb, rids)
    cands, ols, total, _probes = scan_candidates(
        res["kmer"], res["off"], res["span"], valid,
        jnp.asarray(rids, jnp.int32), jnp.asarray(lens),
        jnp.zeros(Q, bool),
        idx.kmers, idx.post_rd, idx.post_dir,
        jnp.asarray(rb.lengths),
        jnp.zeros((Q, 0), jnp.int32), jnp.zeros(Q, jnp.int32),
        budget=1 << 18, ncand=64, kovl=300,
    )
    cands = np.asarray(cands)
    ols = np.asarray(ols)
    assert int(total) < (1 << 18), "budget overflow in test"

    # ground truth intervals from simulated read names: sim%08d_{start}_{len}
    def interval(name):
        parts = name.split("_")
        return int(parts[-2]), int(parts[-2]) + int(parts[-1])

    hits = 0
    checked = 0
    for qi in range(Q):
        qb, qe = interval(rb.names[qi])
        row = cands[qi][cands[qi] >= 0]
        # ol column sorted descending
        olr = ols[qi][cands[qi] >= 0]
        assert all(olr[i] >= olr[i + 1] for i in range(len(olr) - 1))
        # no self, no longer-than-1.2x candidates
        assert qi not in row
        assert all(rb.lengths[c] <= 1.2 * rb.lengths[qi] for c in row)
        # every read overlapping >= 2kb genuinely should be found
        for ci in range(len(rb)):
            if ci == qi or rb.lengths[ci] > 1.2 * rb.lengths[qi]:
                continue
            cb, ce = interval(rb.names[ci])
            ov = min(qe, ce) - max(qb, cb)
            if ov >= 2500:
                checked += 1
                if ci in row:
                    hits += 1
    assert checked > 10
    assert hits / checked > 0.9, f"candidate recall too low: {hits}/{checked}"


def test_candidates_suppression():
    g, rb = _bank()
    idx = build_kmer_index(rb, ksize=16, ksave=4)
    Q = 4
    rids = np.arange(Q)
    res, valid, lens = _query_arrays(rb, rids)
    args = (
        res["kmer"], res["off"], res["span"], valid,
        jnp.asarray(rids, jnp.int32), jnp.asarray(lens),
        jnp.zeros(Q, bool),
        idx.kmers, idx.post_rd, idx.post_dir,
        jnp.asarray(rb.lengths),
    )
    cands0, _, _, _ = scan_candidates(
        *args, jnp.zeros((Q, 0), jnp.int32), jnp.zeros(Q, jnp.int32),
        budget=1 << 18, ncand=32, kovl=300,
    )
    cands0 = np.asarray(cands0)
    # suppress the top candidate of query 0
    top = int(cands0[0, 0])
    sup = np.full((Q, 4), np.iinfo(np.int32).max, np.int32)
    sup[0, 0] = top
    cnt = np.zeros(Q, np.int32)
    cnt[0] = 1
    cands1, _, _, _ = scan_candidates(
        *args, jnp.asarray(sup), jnp.asarray(cnt),
        budget=1 << 18, ncand=32, kovl=300,
    )
    cands1 = np.asarray(cands1)
    assert top not in cands1[0]
    np.testing.assert_array_equal(cands0[1], cands1[1])


def test_candidates_skip_flag():
    g, rb = _bank()
    idx = build_kmer_index(rb, ksize=16, ksave=4)
    Q = 2
    rids = np.arange(Q)
    res, valid, lens = _query_arrays(rb, rids)
    skip = np.array([True, False])
    cands, _, _, _ = scan_candidates(
        res["kmer"], res["off"], res["span"], valid,
        jnp.asarray(rids, jnp.int32), jnp.asarray(lens),
        jnp.asarray(skip),
        idx.kmers, idx.post_rd, idx.post_dir,
        jnp.asarray(rb.lengths),
        jnp.zeros((Q, 0), jnp.int32), jnp.zeros(Q, jnp.int32),
        budget=1 << 18, ncand=32, kovl=300,
    )
    cands = np.asarray(cands)
    assert (cands[0] == -1).all()
    assert (cands[1] >= 0).any()


def test_zmer_index_caps_per_read():
    _, rb = _bank(glen=5000, cov=4)
    zidx = build_zmer_index(rb, zsize=10, max_per_read=4)
    rd = np.asarray(zidx.post_rd)
    zm = np.asarray(zidx.zmers)
    key = zm.astype(np.uint64) << np.uint64(32) | rd.astype(np.uint64)
    _, counts = np.unique(key, return_counts=True)
    assert counts.max() < 4



def _oracle_candidates(res, valid, rids, lens, skip, idx, read_lens, ncand,
                       kovl, len_ratio=1.2):
    """Sequential candidate scan (wtzmo.c:433-573 semantics): per
    (query, candidate, strand) the non-overlapping covered query length of
    the shared k-mers, strands merged by max, >= kovl, top-ncand by
    (-ol, candidate)."""
    kmer = np.asarray(res["kmer"])
    off = np.asarray(res["off"])
    span = np.asarray(res["span"])
    valid = np.asarray(valid)
    ik = np.asarray(idx.kmers)
    ird = np.asarray(idx.post_rd)
    idir = np.asarray(idx.post_dir).astype(np.int64)
    f32 = np.float32
    cands = np.full((len(rids), ncand), -1, np.int64)
    ols = np.zeros((len(rids), ncand), np.int64)
    for q in range(len(rids)):
        if skip[q]:
            continue
        ev = {}
        for j in np.nonzero(valid[q])[0]:
            lo = np.searchsorted(ik, kmer[q, j], "left")
            hi = np.searchsorted(ik, kmer[q, j], "right")
            for e in range(lo, hi):
                c = int(ird[e])
                if c == rids[q] or not (f32(read_lens[c])
                                        <= f32(len_ratio) * f32(lens[q])):
                    continue
                ev.setdefault((c, int(idir[e])), []).append(
                    (int(off[q, j]), min(int(span[q, j]), 255)))
        best = {}
        for (c, _d), hits in ev.items():
            hits.sort()
            ol, prev_end = 0, None
            for qpos, sp in hits:
                ol += sp if prev_end is None else max(
                    0, min(sp, qpos + sp - prev_end))
                prev_end = qpos + sp
            best[c] = max(best.get(c, 0), ol)
        top = sorted((-ol, c) for c, ol in best.items() if ol >= kovl)
        for k, (nol, c) in enumerate(top[:ncand]):
            cands[q, k] = c
            ols[q, k] = -nol
    return cands, ols


@pytest.mark.parametrize("seed,ncand", [(3, 32), (11, 32), (12, 8)])
def test_candidates_match_oracle(seed, ncand):
    """The device group reduce + strand merge + top-A select equals a
    sequential scan of the same postings."""
    g, rb = _bank(seed=seed, glen=12000, cov=6)
    idx = build_kmer_index(rb, ksize=16, ksave=4)
    Q = 4
    rids = np.arange(Q)
    res, valid, lens = _query_arrays(rb, rids)
    skip = np.array([False, False, True, False])
    cands, ols, total, _p = scan_candidates(
        res["kmer"], res["off"], res["span"], valid,
        jnp.asarray(rids, jnp.int32), jnp.asarray(lens), jnp.asarray(skip),
        idx.kmers, idx.post_rd, idx.post_dir, jnp.asarray(rb.lengths),
        jnp.zeros((Q, 0), jnp.int32), jnp.zeros(Q, jnp.int32),
        budget=1 << 17, ncand=ncand, kovl=300,
    )
    assert int(total) < (1 << 17)
    want_c, want_o = _oracle_candidates(res, valid, rids, np.asarray(lens),
                                        skip, idx, rb.lengths, ncand, 300)
    assert (want_c[:, 0] >= 0).sum() >= 2
    np.testing.assert_array_equal(np.asarray(cands), want_c)
    np.testing.assert_array_equal(np.asarray(ols), want_o)
