"""Contiguity statistics — equivalent of the reference seq_n50.pl."""

from __future__ import annotations

import sys


def n50_stats(lengths: list[int]) -> dict:
    lengths = sorted(lengths, reverse=True)
    total = sum(lengths)
    out = {
        "n_seqs": len(lengths),
        "total": total,
        "max": lengths[0] if lengths else 0,
        "min": lengths[-1] if lengths else 0,
        "avg": total // max(1, len(lengths)),
    }
    acc = 0
    marks = {50: "N50", 90: "N90"}
    for ln in lengths:
        acc += ln
        for pct, name in list(marks.items()):
            if acc * 100 >= total * pct:
                out[name] = ln
                del marks[pct]
    for name in marks.values():
        out[name] = 0
    return out


def print_n50(paths, out=None):
    from ..io.fasta import read_seqs

    out = out or sys.stdout
    lengths = [len(seq) for _, _, seq in read_seqs(paths)]
    st = n50_stats(lengths)
    for k in ("n_seqs", "total", "max", "N50", "N90", "min", "avg"):
        out.write(f"{k}\t{st[k]}\n")
    return st


def lcs_length(a: str, b: str) -> int:
    """Length of the longest common subsequence of a and b.

    Bit-parallel (Allison-Dix / Crochemore et al.): one row of the LCS
    table as the bits of a Python int, O(len(a) * len(b) / 64) word
    operations — seconds for whole unitigs, where difflib takes minutes.
    """
    if len(a) < len(b):
        a, b = b, a
    m = len(a)
    mask = (1 << m) - 1
    peq: dict[str, int] = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    v = mask
    for c in b:
        u = v & peq.get(c, 0)
        v = ((v + u) | (v - u)) & mask
    return m - bin(v).count("1")


def lcs_identity(a: str, b: str) -> float:
    """Matched bases over the longer sequence: the quantity difflib's
    matching blocks approximate from below, computed exactly."""
    return lcs_length(a, b) / max(len(a), len(b), 1)


def sampled_chunk_identity(ref: str, ours: str, chunks: int = 60,
                           chunk: int = 8000, seed: int = 11) -> dict:
    """Identity of `ours` against `ref` on sampled windows.

    Samples `chunks` windows of `chunk` bases from `ours`, anchors each in
    `ref` by its first 48 bases (either strand) and scores the window's
    bases matched (longest common subsequence) in the anchored stretch of
    `ref`.  Returns mean/min/median identity and anchor misses.
    """
    import numpy as np

    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(seed)
    idents, misses = [], 0
    for beg in sorted(rng.integers(0, max(1, len(ours) - chunk),
                                   chunks).tolist()):
        piece = ours[beg: beg + chunk]
        at = ref.find(piece[:48])
        if at < 0:
            rc = piece[::-1].translate(comp)
            at = ref.find(rc[:48])
            if at >= 0:
                piece = rc
        if at < 0:
            misses += 1
            continue
        seg = ref[max(0, at - 300): at + chunk + 300]
        idents.append(lcs_length(seg, piece) / len(piece))
    a = np.array(idents) if idents else np.zeros(1)
    return {"chunks": len(idents), "misses": misses, "mean": float(a.mean()),
            "min": float(a.min()), "median": float(np.median(a))}
