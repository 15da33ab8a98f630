"""Sort-join matcher (extract_zmer_pairs_join) vs brute-force oracles.

Two levels: the n x m run emission (`_emit_runs`) on synthetic sorted
join streams against a sequential numpy oracle, and the whole matcher on
a small simulated bank against a direct enumeration of every
(query occurrence, candidate posting) pair of a shared z-mer.
"""

import collections

import numpy as np
import pytest

import jax.numpy as jnp

from smartdenovo_tpu.ops.dotmatrix import _emit_runs, extract_zmer_pairs_join

I32_MAX = (1 << 31) - 1


def oracle_runs(key, pay, aux, mpr):
    """Per emitted slot: (pay, aux, query entry index) in slot order."""
    svalid = key != I32_MAX
    tag0 = svalid & ((key & 1) == 0)
    tag1 = svalid & ((key & 1) == 1)
    grp = key >> 1
    slots = []
    pre0 = rs = 0
    prev = None
    for i in range(len(key)):
        if prev is None or grp[i] != prev:
            rs = pre0
        prev = grp[i]
        if tag1[i] and 0 < pre0 - rs < mpr:
            slots += [(int(pay[i]), int(aux[i]), rs + j)
                      for j in range(pre0 - rs)]
        if tag0[i]:
            pre0 += 1
    return slots


def mkstream(rng, n, max_q=5, max_c=5):
    """Random sorted join stream: groups with query entries first."""
    key, pay, aux = [], [], []
    for g in np.sort(rng.choice(1 << 20, size=n, replace=False)):
        for _ in range(int(rng.integers(0, max_q))):
            key.append(int(g) << 1)
            pay.append(int(rng.integers(-(1 << 30), 1 << 30)))
            aux.append(0)
        for _ in range(int(rng.integers(0, max_c))):
            key.append((int(g) << 1) | 1)
            pay.append(int(rng.integers(-(1 << 30), 1 << 30)))
            aux.append(int(rng.integers(0, 1 << 20)))
        if len(key) >= n:
            break
    key, pay, aux = key[:n], pay[:n], aux[:n]
    pad = n - len(key)
    return (np.array(key + [I32_MAX] * pad, np.int32),
            np.array(pay + [0] * pad, np.int32),
            np.array(aux + [0] * pad, np.int32))


def run_emit(key, pay, aux, mpr, budget):
    cg, ax, base, alive, total = _emit_runs(
        jnp.asarray(key), jnp.asarray(pay), jnp.asarray(aux),
        max_per_read=mpr, pair_budget=budget)
    cg, ax, base, alive = (np.asarray(x) for x in (cg, ax, base, alive))
    p = np.arange(budget)
    return [(int(cg[i]), int(ax[i]), int(base[i] + p[i]))
            for i in np.nonzero(alive)[0]], int(total)


def long_run_stream():
    """A 15-occurrence run (the longest a cap of 16 keeps) feeding a long
    candidate run, then a group after it."""
    key = [2 << 1] * 5 + [(2 << 1) | 1] * 3          # filler group
    key += [7 << 1] * 15 + [(7 << 1) | 1] * 40       # 15 x 40 emission
    key += [9 << 1] * 2 + [(9 << 1) | 1]
    n = 128
    key += [I32_MAX] * (n - len(key))
    pay = np.arange(n, dtype=np.int32) * 7 + 1
    aux = np.arange(n, dtype=np.int32) + 1000
    return np.array(key, np.int32), pay, aux


def cap_stream():
    """Groups with >= max_per_read query entries emit nothing."""
    key = [3 << 1] * 4 + [(3 << 1) | 1] + [5 << 1] * 2 + [(5 << 1) | 1]
    key += [I32_MAX] * (64 - len(key))
    pay = np.zeros(64, np.int32)
    pay[7] = 77
    return np.array(key, np.int32), pay, np.zeros(64, np.int32)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_emit_runs_matches_oracle(seed):
    key, pay, aux = mkstream(np.random.default_rng(seed), 2048)
    want = oracle_runs(key, pay, aux, 16)
    got, total = run_emit(key, pay, aux, 16, 4096)
    assert total == len(want)
    assert got == want


def test_emit_runs_long_runs():
    key, pay, aux = long_run_stream()
    want = oracle_runs(key, pay, aux, 16)
    got, total = run_emit(key, pay, aux, 16, 1024)
    assert total == len(want) == 5 * 3 + 15 * 40 + 2
    assert got == want


def test_emit_runs_max_per_read_cap():
    key, pay, aux = cap_stream()
    got, total = run_emit(key, pay, aux, 4, 64)
    assert total == 2
    assert [g[0] for g in got] == [77, 77]


def test_emit_runs_budget_truncates():
    """Slots past the pair budget are dropped; the total still counts
    them, so the caller can see the overflow and redispatch."""
    key, pay, aux = mkstream(np.random.default_rng(4), 2048)
    want = oracle_runs(key, pay, aux, 16)
    budget = len(want) // 2
    got, total = run_emit(key, pay, aux, 16, budget)
    assert total == len(want)
    assert got == want[:budget]


def test_emit_runs_wide_cap():
    """A cap above 16 keeps runs longer than 16 slots intact."""
    key = np.array([4 << 1] * 30 + [(4 << 1) | 1] * 3 + [I32_MAX] * 95,
                   np.int32)
    pay = np.arange(128, dtype=np.int32)
    aux = np.arange(128, dtype=np.int32)
    want = oracle_runs(key, pay, aux, 64)
    got, total = run_emit(key, pay, aux, 64, 256)
    assert total == len(want) == 90
    assert got == want


# ---------------------------------------------------------------------------
# the whole matcher on a simulated bank
# ---------------------------------------------------------------------------


def _bank_inputs(seed):
    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.ops.flatseeds import build_bank_indexes, gather_query_rows
    from smartdenovo_tpu.pipeline.zmo import _upload_bank
    from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads

    g = random_genome(np.random.default_rng(seed), 12_000)
    names, seqs = simulate_reads(g, coverage=6, mean_len=2500, err=0.12,
                                 seed=seed + 1, min_len=800)
    rb = ReadBank(names, seqs)
    flat, offs, lens, _T, _N = _upload_bank(rb)
    _k16, z10, didx = build_bank_indexes(
        flat, offs, lens, ksize=16, zsize=10, ksave=4, max_zmer_freq=16,
        zbits=20)
    Q, A, Lc = 4, 8, 16384
    rids = np.arange(Q, dtype=np.int32)
    # candidates: every other read, sorted, INT32_MAX padded
    cands = np.full((Q, A), I32_MAX, np.int32)
    for q in range(Q):
        c = [r for r in range(Q, len(rb)) if (r + q) % 2 == 0][:A]
        cands[q, :len(c)] = c
    rows = gather_query_rows(z10, jnp.asarray(rids), Lc)
    return rb, didx, rows, cands


def oracle_pairs(rows, cands, didx, read_lens, mpr, kvar):
    """Every (query occurrence, candidate posting) pair of a shared z-mer,
    after the per-(read, z-mer) occurrence cap on the query side."""
    qz, qoff, qspan, qdir, qvalid = (np.asarray(x) for x in rows)
    zsd, pk = np.asarray(didx.rm_zsd), np.asarray(didx.rm_pk)
    start = np.asarray(didx.rm_start)
    Q, A = cands.shape
    recs = collections.Counter()
    for q in range(Q):
        occ = collections.defaultdict(list)
        for j in np.nonzero(qvalid[q])[0]:
            occ[int(qz[q, j])].append(
                (int(qoff[q, j]), min(int(qspan[q, j]), 255), int(qdir[q, j])))
        for a in range(A):
            c = int(cands[q, a])
            if c == I32_MAX:
                continue
            for e in range(start[c], start[c + 1]):
                z = int(zsd[e]) >> 9
                if z >= (1 << 20):
                    continue              # alignment gap entry
                qs = occ.get(z, [])
                if not 0 < len(qs) < mpr:
                    continue
                p_off, p_span, p_dir = (int(pk[e]) >> 9,
                                        (int(pk[e]) >> 1) & 0xFF,
                                        int(pk[e]) & 1)
                for o1, s1, d1 in qs:
                    if abs(s1 - p_span) > kvar:
                        continue
                    pdir = d1 ^ p_dir
                    o2 = (int(read_lens[c]) - (p_off + p_span) if pdir
                          else p_off)
                    recs[((q * A + a) * 2 + pdir, (o1 << 8) | s1,
                          (o2 << 8) | p_span)] += 1
    return recs


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_join_matches_bruteforce(seed):
    rb, didx, rows, cands = _bank_inputs(seed)
    read_lens = rb.lengths.astype(np.int32)
    qz, qoff, qspan, qdir, qvalid = rows
    pb = extract_zmer_pairs_join(
        qz, qdir, qoff, qspan, qvalid, jnp.asarray(cands),
        didx.rm_zsd, didx.rm_pk, didx.rm_start, jnp.asarray(read_lens),
        expand_budget=1 << 17, pair_budget=1 << 16, kvar=2, zbits=20,
        max_per_read=16, qprobe_budget=1 << 15)
    assert int(pb.total) < (1 << 16) and int(pb.expand_total) <= (1 << 17)
    pid = np.asarray(pb.pair_id)
    live = pid < cands.size * 2
    got = collections.Counter(zip(pid[live].tolist(),
                                  np.asarray(pb.o1l1)[live].tolist(),
                                  np.asarray(pb.o2l2)[live].tolist()))
    want = oracle_pairs(rows, cands, didx, read_lens, 16, 2)
    assert sum(want.values()) > 100
    assert got == want
