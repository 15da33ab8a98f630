"""The vectorised read simulator against its plain per-base reference,
and the sampled-chunk identity used to score consensus against truth."""

import numpy as np
import pytest

from smartdenovo_tpu.utils.simulate import (bench_read_set, mutate_read,
                                            random_genome, simulate_reads)
from smartdenovo_tpu.utils.stats import sampled_chunk_identity


def mutate_read_loop(rng, seq, err, sub_frac=0.15, ins_frac=0.55,
                     del_frac=0.30, hp_bias=0.75):
    """Per-base reference of mutate_read (same draws, same order)."""
    if err <= 0:
        return seq.copy()
    n = len(seq)
    p_sub, p_ins, p_del = err * sub_frac, err * ins_frac, err * del_frac
    r = rng.random(n)
    hp = rng.random(n) < hp_bias
    coin = rng.random(n) < 0.5
    ins_bases = rng.integers(0, 4, size=n, dtype=np.int64)
    sub_shift = rng.integers(1, 4, size=n, dtype=np.int64)
    out, prev = [], -1
    for j in range(n):
        c, x = int(seq[j]), r[j]
        indel = x < p_del + p_ins
        if indel and hp[j]:
            if coin[j]:
                out += [c, c]
                prev = c
            elif c != prev:
                out.append(c)
                prev = c
        elif x < p_del:
            continue
        elif indel:
            out += [int(ins_bases[j]), c]
            prev = c
        elif x < p_del + p_ins + p_sub:
            c = (c + int(sub_shift[j])) % 4
            out.append(c)
            prev = c
        else:
            out.append(c)
            prev = c
    return np.array(out, dtype=np.uint8)


@pytest.mark.parametrize("seed,err,homopolymer", [
    (1, 0.13, False), (2, 0.4, False), (3, 0.95, False), (4, 0.13, True)])
def test_mutate_read_matches_loop(seed, err, homopolymer):
    g = random_genome(np.random.default_rng(seed), 5000)
    if homopolymer:
        g[1000:1400] = 2           # long run: shrink/grow chains
    a = mutate_read(np.random.default_rng(seed + 50), g, err)
    b = mutate_read_loop(np.random.default_rng(seed + 50), g, err)
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_bench_read_set_shape():
    _g, names, seqs = bench_read_set(60_000, 4)
    g2 = random_genome(np.random.default_rng(2026), 60_000)
    n2, s2 = simulate_reads(g2, coverage=4, mean_len=9000, err=0.13,
                            seed=2027)
    assert names == n2
    assert all(np.array_equal(x, y) for x, y in zip(seqs, s2))


def test_sampled_identity_both_strands():
    rng = np.random.default_rng(9)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 40_000))
    rc = ref[::-1].translate(str.maketrans("ACGT", "TGCA"))
    for ours in (ref[5000:30000], rc[2000:20000]):
        r = sampled_chunk_identity(ref, ours, chunks=5, chunk=2000)
        assert r["chunks"] == 5 and r["misses"] == 0
        assert r["min"] == 1.0


def test_sampled_identity_counts_errors():
    rng = np.random.default_rng(10)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 30_000))
    s = list(ref)
    for i in range(100, 30_000, 100):           # 1 % substitutions
        s[i] = "A" if s[i] != "A" else "C"
    r = sampled_chunk_identity(ref, "".join(s), chunks=4, chunk=3000)
    assert 0.985 < r["mean"] < 0.995


def _lcs_dp(a, b):
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[j]))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("seed,na,nb", [(1, 200, 180), (2, 50, 300),
                                        (3, 257, 257)])
def test_lcs_length_matches_dp(seed, na, nb):
    import difflib

    from smartdenovo_tpu.utils.stats import lcs_length

    rng = np.random.default_rng(seed)
    a = "".join("ACGT"[i] for i in rng.integers(0, 4, na))
    b = "".join("ACGT"[i] for i in rng.integers(0, 4, nb))
    want = _lcs_dp(a, b)
    assert lcs_length(a, b) == lcs_length(b, a) == want
    sm = difflib.SequenceMatcher(None, a, b, autojunk=False)
    assert sum(x.size for x in sm.get_matching_blocks()) <= want
