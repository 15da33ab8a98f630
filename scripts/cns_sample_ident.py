#!/usr/bin/env python
"""Sampled chunk identity between two long consensi (difflib is
quadratic, so sample windows instead of whole-sequence alignment).

Usage: python scripts/cns_sample_ident.py REF.fa OURS.fa|CKPT.npz
                                          [--chunks 60] [--chunk 8000]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smartdenovo_tpu.utils.stats import sampled_chunk_identity  # noqa: E402


def load_seq(path):
    if path.endswith(".npz"):
        from smartdenovo_tpu.data.readbank import codes_to_seq

        z = np.load(path, allow_pickle=True)
        return codes_to_seq(z["cns"]), int(z["it"])
    seqs = []
    for line in open(path):
        if not line.startswith(">"):
            seqs.append(line.strip())
    return "".join(seqs), None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("ours")
    ap.add_argument("--chunks", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=8000)
    args = ap.parse_args()
    ref, _ = load_seq(args.ref)
    ours, it = load_seq(args.ours)
    print(f"ref {len(ref)} bp, ours {len(ours)} bp"
          + (f" (checkpoint after iteration {it})" if it else ""))
    r = sampled_chunk_identity(ref, ours, args.chunks, args.chunk)
    print(f"sampled {r['chunks']} chunks ({r['misses']} anchor misses): "
          f"mean {r['mean']:.5f}, min {r['min']:.5f}, "
          f"median {r['median']:.5f}")


if __name__ == "__main__":
    main()
