"""smartdenovo_tpu — a device-native de-novo assembler for noisy long reads.

A from-scratch reimplementation of the capabilities of SMARTdenovo
(ruanjue/smartdenovo): a correction-free Overlap-Layout-Consensus
pipeline for PacBio / Oxford Nanopore reads.

Architecture (accelerator-first, not a port):

- ``data``     packed read store; batched device tensors of 2-bit bases
- ``ops``      JAX/XLA device compute: homopolymer-compressed k-mer
               ("zmer") seeding, sorted-index candidate scan, dot-matrix
               alignment (sorts + scans + small dense chain DP), batched
               banded Smith-Waterman wavefront kernels
- ``graph``    host graph plane: read clipping (wtclp), string graph /
               best-overlap-graph layout (wtlay), DAG consensus (dagcns)
- ``pipeline`` stage drivers mirroring the reference CLI stage contracts
               (wtpre, wtzmo, wtclp, wtlay, wtcns) and the end-to-end
               smartdenovo.pl equivalent
- ``parallel`` device-mesh sharding of the overlap stage (data-parallel
               read batches, kmer-hash-sharded index, collectives)

Stage file formats (17-column overlap TSV, clip mask TSV, .lay/.utg
layout) are kept bit-compatible with the reference so outputs can be
cross-checked against the reference binaries.
"""

__version__ = "0.1.0"
