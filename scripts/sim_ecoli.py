#!/usr/bin/env python
"""Generate the E. coli-scale parity/benchmark dataset deterministically.

The BASELINE target dataset (PBcR selfSampleData E. coli PacBio reads,
reference README.md:3-12) cannot be fetched in this environment (no
network egress), so parity and performance are measured on a seeded
simulation at the same scale: 4.6 Mb genome, ~18x coverage, PacBio-like
indel-dominated 13% error profile (utils/simulate.py).  Parity remains
meaningful because every comparison is ours-vs-reference-binary on the
SAME input reads.

Writes work/ecoli_reads.fa (~83 Mb).  Fully deterministic (fixed seeds),
so artifacts are reproducible from a fresh checkout.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from smartdenovo_tpu.utils.simulate import ecoli_read_set, write_sim_fasta


def main():
    out = os.path.join(ROOT, "work", "ecoli_reads.fa")
    gfile = os.path.join(ROOT, "work", "ecoli_genome.fa")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    glen = int(os.environ.get("ECOLI_GENOME", 4_600_000))
    cov = float(os.environ.get("ECOLI_COV", 18))
    t0 = time.time()
    genome, names, seqs = ecoli_read_set(glen, cov)
    write_sim_fasta(out, names, seqs)
    from smartdenovo_tpu.data.readbank import codes_to_seq
    from smartdenovo_tpu.io.fasta import write_fasta
    with open(gfile, "w") as fh:
        write_fasta(fh, "ecoli_sim_genome", codes_to_seq(genome))
    total = sum(len(s) for s in seqs)
    print(f"wrote {out}: {len(seqs)} reads, {total} bases "
          f"({total / glen:.1f}x) in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
