#!/usr/bin/env python
"""Benchmark: all-vs-all overlap stage vs the reference wtzmo (dmo mode).

Generates a synthetic PacBio-like dataset, runs our overlapper on the GPU
(in this process; it exits non-zero without one) and the reference CPU
binary (if buildable) on identical input, and prints a device line, then
ONE JSON line:
  {"metric": "overlaps_per_sec", "value": N, "unit": "ovl/s", "vs_baseline": R}
vs_baseline = reference wall-clock / our wall-clock on the same dataset
(>1 means faster than the multithreaded CPU reference on this machine).

Environment knobs: BENCH_GENOME=500000 BENCH_COV=15 BENCH_THREADS=<nproc>.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def build_reference(refdir: str) -> str | None:
    """Build the reference binaries (benchmark baseline only)."""
    src = "/root/reference"
    if not os.path.isdir(src):
        return None
    os.makedirs(refdir, exist_ok=True)
    wtzmo = os.path.join(refdir, "wtzmo")
    if not os.path.exists(wtzmo):
        import glob
        import shutil

        for f in glob.glob(os.path.join(src, "*.c")) + glob.glob(
            os.path.join(src, "*.h")
        ) + [os.path.join(src, "Makefile")]:
            shutil.copy(f, refdir)
        r = subprocess.run(["make", "-j4", "wtzmo"], cwd=refdir,
                           capture_output=True, timeout=600)
        if r.returncode != 0 or not os.path.exists(wtzmo):
            return None
    return wtzmo


def require_gpu():
    """Print the device line; exit non-zero unless JAX's default device
    is a GPU (a CPU number is never reported as the bench metric)."""
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"[bench] device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if d.platform != "gpu":
        sys.exit(f"[bench] no GPU found (platform {d.platform!r}); not "
                 "measuring")


def run_ours(rb):
    """Time our overlap stage in this process.

    One cold pass pays the XLA compiles (reported as set-up, like the
    reference's gcc build); the metric is the median of three warm
    passes.  Returns (overlaps, median warm seconds)."""
    from smartdenovo_tpu.pipeline.zmo import ZmoParams, overlap_dmo
    from smartdenovo_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    # -A 1000, same as the reference cmd; SDTPU_BENCH_Q / SDTPU_BENCH_MATCHER
    # override the query batch width / matcher for experiments
    params = ZmoParams.dmo(
        batch_q=int(os.environ.get("SDTPU_BENCH_Q", "64")),
        matcher=os.environ.get("SDTPU_BENCH_MATCHER", "auto"))
    t0 = time.time()
    overlaps = overlap_dmo(rb, params, progress=True)
    cold = time.time() - t0
    print(f"[bench] cold pass: {len(overlaps)} overlaps in {cold:.1f}s",
          file=sys.stderr, flush=True)
    walls = []
    for _ in range(3):
        t0 = time.time()
        overlaps = overlap_dmo(rb, params, progress=False)
        walls.append(time.time() - t0)
    print("[bench] warm passes: " + " ".join(f"{w:.3f}s" for w in walls),
          file=sys.stderr, flush=True)
    return overlaps, float(np.median(walls))


def main():
    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.utils.simulate import bench_read_set, write_sim_fasta

    require_gpu()
    glen = int(os.environ.get("BENCH_GENOME", 500_000))
    cov = float(os.environ.get("BENCH_COV", 15))
    threads = int(os.environ.get("BENCH_THREADS", os.cpu_count() or 4))
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work")
    os.makedirs(workdir, exist_ok=True)

    fasta_env = os.environ.get("BENCH_FASTA")
    if fasta_env and os.path.exists(fasta_env):
        # bench an existing read set (e.g. the E. coli parity set, so the
        # perf number and the parity number describe the same workload)
        fasta = fasta_env
        rb = ReadBank.from_fasta(fasta)
    else:
        _genome, names, seqs = bench_read_set(glen, cov)
        rb = ReadBank(names, seqs)
        fasta = os.path.join(workdir, "bench_reads.fa")
        write_sim_fasta(fasta, rb.names, [rb.get(i) for i in range(len(rb))])
    print(f"[bench] {len(rb)} reads, {rb.total_bases} bases", file=sys.stderr)

    overlaps, ours_t = run_ours(rb)
    n_ovl = len(overlaps)
    print(f"[bench] ours: {n_ovl} overlaps in {ours_t:.1f}s", file=sys.stderr)

    # ---- reference (CPU) ----
    ref_t = None
    wtzmo = build_reference(os.path.join(workdir, "refbuild"))
    if wtzmo:
        out = os.path.join(workdir, "ref.ovl")
        cmd = [wtzmo, "-t", str(threads), "-i", fasta, "-fo", out,
               "-k", "16", "-z", "10", "-Z", "16", "-U", "-1",
               "-m", "0.1", "-A", "1000"]
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=4 * 3600)
            if r.returncode == 0:
                ref_t = time.time() - t0
                n_ref = sum(1 for _ in open(out))
                print(f"[bench] reference: {n_ref} overlaps in {ref_t:.1f}s "
                      f"({threads} threads)", file=sys.stderr)
        except subprocess.TimeoutExpired:
            print("[bench] reference timed out", file=sys.stderr)

    rate = n_ovl / ours_t if ours_t > 0 else 0.0
    vs = (ref_t / ours_t) if (ref_t and ours_t > 0) else 0.0
    print(json.dumps({
        "metric": "overlaps_per_sec",
        "value": round(rate, 2),
        "unit": "ovl/s",
        "vs_baseline": round(vs, 3),
    }))


if __name__ == "__main__":
    main()
