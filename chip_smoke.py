#!/usr/bin/env python
"""On-card smoke test: drive the assembler's main path on an NVIDIA GPU.

Usage:
  python chip_smoke.py              # default phases, one card
  python chip_smoke.py --cards 4    # only the sharded overlap, on 4 cards

Everything runs in this one process, through the CLI's own entry points
(`smartdenovo_tpu.cli.main`), with the persistent compile cache of
`utils/cache.py`.  Default phases:

  device      platform, device kind and count; the card's name and power
              limit as nvidia-smi reports them
  xla-vs-cpu  one 64-query batch of the bench read set at the budgets
              overlap_dmo picks for it: index build -> candidate scan ->
              z-mer matcher -> dot-matrix chain, once on the GPU and once
              on the CPU; every output array must be equal
  golden      `asm -e dmo -c 1` on tests/goldens/smoke.fa: the overlap
              pair set equals the reference binary's on the reads asm
              keeps (-J 5000); our layout and
              consensus on the reference's own inputs match its .lay.utg
              exactly and its .cns at >= 0.9985 identity (bases matched
              over all unitigs)
  bench       `asm -c 1` on the bench read set (500 kb genome, 15x): the
              largest unitig covers >= 0.9 of the genome and the consensus
              reaches >= 0.978 sampled identity against it; then the
              overlap stage at bench widths: one profiler trace for its
              device time, and its warm wall-clock
  ecoli-zmo   `zmo` on the E. coli-scale read set (4.6 Mb, 18x, 8,354
              reads): 131,763 unique read pairs, the reference binary's
              count on this seed (at most 0.1 % off, any difference shown)

Each phase prints one line with its cold seconds (compiles included), its
counts and the device's peak memory so far.  Any failure raises, so the
process exits non-zero; without a GPU it exits non-zero before any phase.
The last line of standard output is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "goldens")
WORK = os.path.join(ROOT, "work", "chip_smoke")
ECOLI_PAIRS = 131_763     # reference wtzmo's unique pairs on this read set


class PhaseError(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def peak_bytes():
    import jax

    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def report(name, t0, **fields):
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {time.time() - t0:.1f}s {kv} "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)


def fasta_seqs(path):
    from smartdenovo_tpu.io.fasta import read_seqs

    return {tag: seq for tag, _d, seq in read_seqs([path])}


def pair_set(path, rename=None):
    """Unique unordered read-name pairs of an .ovl file (the counting of
    scripts/parity_ecoli.py load_pairs)."""
    pairs = set()
    with open(path) as fh:
        for line in fh:
            c = line.split("\t")
            if len(c) < 12:
                continue
            a, b = c[0], c[5]
            if rename:
                a, b = rename[a], rename[b]
            pairs.add((min(a, b), max(a, b)))
    return pairs


def write_reads(path, names, seqs):
    from smartdenovo_tpu.utils.simulate import write_sim_fasta

    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_sim_fasta(path, names, seqs)
    return path


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(cards):
    import jax

    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    devs = jax.devices()
    check(len(devs) >= cards, f"{cards} cards asked, {len(devs)} present")
    report("device", t0, platform=devs[0].platform,
           kind=repr(devs[0].device_kind), count=len(devs))


def phase_xla_vs_cpu(rb):
    """GPU vs CPU on one production batch: index build + _cand_core +
    _pair_core, every output array compared exactly."""
    import jax
    import numpy as np

    from smartdenovo_tpu.ops.flatseeds import build_bank_indexes
    from smartdenovo_tpu.pipeline import zmo as Z

    t0 = time.time()
    p = Z.ZmoParams.dmo()
    # record the statics overlap_dmo computes for its first chunk
    seen = {}
    real = {"cand": Z._cand_scan_device, "pair": Z._pair_scan_device}

    def recorder(kind):
        def call(*args, **st):
            seen.setdefault(kind, (args, st))
            return real[kind](*args, **st)
        return call

    Z._cand_scan_device = recorder("cand")
    Z._pair_scan_device = recorder("pair")
    try:
        Z.overlap_dmo(rb, p, progress=False)
    finally:
        Z._cand_scan_device = real["cand"]
        Z._pair_scan_device = real["pair"]
    (rids_all, qlens_all, qskip_all, *_), cst = seen["cand"]
    pst = seen["pair"][1]
    idx_kw = dict(ksize=p.ksize, zsize=p.zsize, hz=p.hz, ksave=p.ksave,
                  max_kmer_freq=p.max_kmer_freq,
                  max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)

    @jax.jit
    def step(flat, offs, lens, rids, qlens, qskip, read_lens):
        k16, z10, didx = build_bank_indexes(flat, offs, lens, **idx_kw)
        csorted, osorted, sizes = Z._cand_core(
            rids, qlens, qskip, k16, didx, read_lens, **cst)
        res, totals = Z._pair_core(rids, qlens, csorted, z10, didx,
                                   read_lens, **pst)
        return dict(k16=k16, z10=z10, didx=didx, csorted=csorted,
                    osorted=osorted, sizes=sizes, res=res, totals=totals)

    flat, offs, lens, _T, _N = Z._upload_bank(rb)
    host = [np.asarray(x) for x in (
        flat, offs, lens, rids_all[0], qlens_all[0], qskip_all[0],
        rb.lengths.astype(np.int32))]
    gpu = jax.device_get(step(*[jax.device_put(x, jax.devices()[0])
                                for x in host]))
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = jax.device_get(step(*[jax.device_put(x, cpu_dev)
                                    for x in host]))
    leaves_g = jax.tree_util.tree_leaves_with_path(gpu)
    leaves_c = jax.tree_util.tree_leaves(cpu)
    diff = [(jax.tree_util.keystr(k), int(np.sum(np.asarray(a) != np.asarray(b))))
            for (k, a), b in zip(leaves_g, leaves_c)
            if np.shape(a) != np.shape(b) or not np.array_equal(a, b)]
    n_elems = sum(int(np.size(a)) for _k, a in leaves_g)
    for name, n in diff:
        print(f"[xla-vs-cpu] differs: {name}: {n} elements", flush=True)
    check(not diff, f"{len(diff)} of {len(leaves_g)} arrays differ")
    report("xla-vs-cpu", t0, matcher=pst["matcher"], mb=pst["mb"],
           pb=pst["pb"], nbk=pst["nbk"], pd=pst["pd"], cbud=cst["cbud"],
           arrays=len(leaves_g), elements=n_elems, mismatches=0)


def phase_golden(cli):
    from smartdenovo_tpu.io.fasta import read_seqs_qual
    from smartdenovo_tpu.pipeline.pre import preprocess
    from smartdenovo_tpu.utils.stats import lcs_identity, n50_stats

    t0 = time.time()
    smoke = os.path.join(GOLD, "smoke.fa")
    out = os.path.join(WORK, "golden")
    os.makedirs(out, exist_ok=True)
    prefix = os.path.join(out, "smk")
    cli.main(["asm", smoke, "-p", prefix, "-e", "dmo", "-c", "1"])
    t_asm = time.time() - t0
    # asm renames reads pb%012d after preprocessing; map back by sequence
    by_seq = {seq: tag for tag, _d, seq, *_ in read_seqs_qual([smoke])}
    rename = {rec[0]: by_seq[rec[1]] for rec in
              preprocess(read_seqs_qual([smoke]), min_len=5000)}
    ours = pair_set(prefix + ".dmo.ovl", rename)
    # the reference ran on all reads; asm's -J 5000 keeps the longer ones
    kept = set(rename.values())
    ref = {p for p in pair_set(os.path.join(GOLD, "smoke.ref.ovl"))
           if p[0] in kept and p[1] in kept}
    common = len(ours & ref)
    check(ours == ref, f"overlap pairs: ours {len(ours)}, ref {len(ref)}, "
                       f"common {common}")
    own_cns = n50_stats([len(s) for s in
                         fasta_seqs(prefix + ".dmo.cns").values()])
    # our layout on the reference's overlaps and clips (test_lay_golden_cross)
    lay = os.path.join(out, "cross.lay")
    cli.main(["lay", "-i", smoke, "-b", os.path.join(GOLD, "smoke.ref.obt"),
              "-j", os.path.join(GOLD, "smoke.ref.ovl"), "-o", lay,
              "-s", "200", "-m", "0.1", "-w", "300", "-r", "0.95", "-c", "1"])
    ours_utg = sorted(fasta_seqs(lay + ".utg").values())
    ref_utg = sorted(fasta_seqs(os.path.join(GOLD, "smoke.ref.lay.utg"))
                     .values())
    check(ours_utg == ref_utg, "unitigs differ from the reference binary's")
    # our consensus on the reference's layout (test_cns_golden_cross)
    cns = os.path.join(out, "cross.cns")
    t1 = time.time()
    cli.main(["cns", "-i", os.path.join(GOLD, "smoke.ref.lay"), "-o", cns])
    t_cns = time.time() - t1
    ours_cns = fasta_seqs(cns)
    ref_cns = fasta_seqs(os.path.join(GOLD, "smoke.ref.cns"))
    check(set(ours_cns) == set(ref_cns), "consensus unitig names differ")
    idents = {k: lcs_identity(ours_cns[k], ref_cns[k]) for k in sorted(ref_cns)}
    # bases matched over all unitigs: 0.9985 is the bar of
    # tests/test_goldens.py, applied to the whole golden (per unitig,
    # two of the four sit at 0.9983-0.9985 on the CPU too)
    span = {k: max(len(ours_cns[k]), len(ref_cns[k])) for k in ref_cns}
    whole = sum(idents[k] * span[k] for k in span) / sum(span.values())
    check(whole >= 0.9985, f"consensus identity {whole:.5f}: {idents}")
    report("golden", t0, asm_s=f"{t_asm:.1f}", reads=len(kept),
           pairs=len(ours),
           ref_pairs=len(ref), common=common, utg=len(ours_utg),
           own_cns_total=own_cns["total"], cross_cns_s=f"{t_cns:.1f}",
           cns_identity=f"{whole:.5f}",
           per_unitig=",".join(f"{v:.5f}" for v in idents.values()))


def phase_bench(cli, genome, rb):
    from smartdenovo_tpu.data.readbank import codes_to_seq
    from smartdenovo_tpu.pipeline.zmo import ZmoParams, overlap_dmo
    from smartdenovo_tpu.utils.stats import sampled_chunk_identity

    t0 = time.time()
    fa = write_reads(os.path.join(WORK, "bench", "bench_reads.fa"), rb.names,
                     [rb.get(i) for i in range(len(rb))])
    prefix = os.path.join(WORK, "bench", "bench")
    cli.main(["asm", fa, "-p", prefix, "-c", "1"])
    t_asm = time.time() - t0
    glen = len(genome)
    utg = max(len(s) for s in fasta_seqs(prefix + ".dmo.lay.utg").values())
    cns = max(fasta_seqs(prefix + ".dmo.cns").values(), key=len)
    ident = sampled_chunk_identity(codes_to_seq(genome), cns)
    check(utg >= 0.9 * glen, f"largest unitig {utg} < 0.9 x {glen}")
    check(ident["chunks"] > 0 and ident["mean"] >= 0.978,
          f"consensus identity {ident}")
    # the overlap stage at bench.py's widths (all reads, batch_q 64; the
    # shapes were compiled by the xla-vs-cpu phase): one traced pass for
    # the device time, then the warm wall-clock with the profiler off
    # (tracing slows the host, so the idle share divides by the untraced
    # wall).  The trace comes first: after a few runs XLA replays a
    # step as one CUDA graph, whose trace no longer names the kernels.
    import jax
    import numpy as np

    tdir = os.path.join(WORK, "trace")
    t1 = time.time()
    with jax.profiler.trace(tdir):
        ovls = overlap_dmo(rb, ZmoParams.dmo(), progress=False)
    t_trace = time.time() - t1
    walls = []
    for _ in range(3):
        t1 = time.time()
        overlap_dmo(rb, ZmoParams.dmo(), progress=False)
        walls.append(time.time() - t1)
    warm = float(np.median(walls))
    summary = summarize_trace(newest_xplane(tdir))
    with open(os.path.join(WORK, "trace_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    p2 = summary["modules"].get("jit__pair_scan_device", {})
    report("bench", t0, asm_s=f"{t_asm:.1f}", genome=glen, largest_utg=utg,
           cns_len=len(cns), cns_ident_mean=f"{ident['mean']:.5f}",
           cns_ident_min=f"{ident['min']:.5f}", chunks=ident["chunks"],
           overlaps=len(ovls), warm_wall_s=f"{warm:.3f}",
           traced_wall_s=f"{t_trace:.3f}",
           device_busy_ms=f"{summary['busy_ms']:.1f}",
           device_idle_share=f"{1 - summary['busy_ms'] / 1e3 / warm:.3f}",
           phase2_ms=f"{p2.get('ms', 0.0):.1f}",
           phase2_scatter_share=f"{p2.get('scatter_share', 0.0):.3f}")
    for cat, ms in p2.get("by_kind", {}).items():
        print(f"[bench] phase2 {cat}: {ms:.1f} ms", flush=True)
    top = list(p2.get("ops", {}).items())[:5]
    print("[bench] phase2 top ops: " + ", ".join(
        f"{op} {ms:.1f} ms" for op, ms in top), flush=True)


def newest_xplane(tdir):
    paths = sorted(glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    check(paths, f"no trace under {tdir}")
    return paths[-1]


KINDS = ("scatter", "sort", "gather", "reduce", "scan", "copy")


def summarize_trace(path):
    """Device time per jitted module and per kind of HLO op (the kind is
    the first of KINDS in the op's name, else "other")."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    modules = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                mod = st.get("hlo_module")
                if mod is None:
                    continue
                op = str(st.get("hlo_op", ev.name))
                kind = next((k for k in KINDS if k in op.lower()), "other")
                m = modules.setdefault(mod, {"ms": 0.0, "by_kind": {},
                                             "ops": {}})
                ms = ev.duration_ns / 1e6
                m["ms"] += ms
                m["by_kind"][kind] = m["by_kind"].get(kind, 0.0) + ms
                m["ops"][op] = m["ops"].get(op, 0.0) + ms
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    for m in modules.values():
        m["scatter_share"] = m["by_kind"].get("scatter", 0.0) / max(m["ms"], 1e-9)
        m["ops"] = dict(sorted(m["ops"].items(), key=lambda kv: -kv[1])[:25])
    window = (max(b for _a, b in spans) - min(a for a, _b in spans)) if spans else 0
    return {"busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "modules": modules}


def phase_ecoli(cli):
    from smartdenovo_tpu.utils.simulate import ecoli_read_set

    t0 = time.time()
    _genome, names, seqs = ecoli_read_set()
    fa = write_reads(os.path.join(WORK, "ecoli", "ecoli_reads.fa"), names, seqs)
    t_gen = time.time() - t0
    out = os.path.join(WORK, "ecoli", "ecoli.ovl")
    t1 = time.time()
    cli.main(["zmo", "-i", fa, "-o", out, "-m", "0.1", "-A", "1000",
              "--batch-q", "64"])
    t_zmo = time.time() - t1
    n = len(pair_set(out))
    delta = n - ECOLI_PAIRS
    if delta:
        print(f"[ecoli-zmo] pair count differs from {ECOLI_PAIRS} by {delta}",
              flush=True)
    check(abs(delta) <= ECOLI_PAIRS // 1000,
          f"{n} pairs vs {ECOLI_PAIRS} (more than 0.1 % off)")
    report("ecoli-zmo", t0, reads=len(names), bases=sum(len(s) for s in seqs),
           gen_s=f"{t_gen:.1f}", zmo_s=f"{t_zmo:.1f}", pairs=n,
           expected=ECOLI_PAIRS, delta=delta)


def phase_sharded(cards, rb):
    """Sharded overlap (rd x idx mesh) vs single-card overlap_dmo."""
    import jax

    from smartdenovo_tpu.parallel.sharded import (make_overlap_mesh,
                                                  overlap_sharded)
    from smartdenovo_tpu.pipeline.zmo import ZmoParams, overlap_dmo

    t0 = time.time()
    p = ZmoParams.dmo()
    mesh = make_overlap_mesh(jax.devices()[:cards], idx_shards=2)
    sharded = overlap_sharded(rb, p, mesh, progress=False)
    t_sh = time.time() - t0
    t1 = time.time()
    single = overlap_dmo(rb, p, progress=False)
    t_single = time.time() - t1

    def pairs(ovls):
        return {(min(o.rid1, o.rid2), max(o.rid1, o.rid2)) for o in ovls}

    ps, p1 = pairs(sharded), pairs(single)
    jac = len(ps & p1) / max(1, len(ps | p1))
    report("sharded", t0, mesh=f"rd={mesh.devices.shape[0]}x"
           f"idx={mesh.devices.shape[1]}", sharded_s=f"{t_sh:.1f}",
           single_s=f"{t_single:.1f}", sharded_pairs=len(ps),
           single_pairs=len(p1), only_sharded=len(ps - p1),
           only_single=len(p1 - ps), jaccard=f"{jac:.5f}")
    check(ps == p1, "sharded pair set differs from the single-card one")


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 = run only the sharded overlap on four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from smartdenovo_tpu import cli
    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.utils.cache import enable_compilation_cache
    from smartdenovo_tpu.utils.simulate import bench_read_set

    enable_compilation_cache()
    phase_device(args.cards)
    genome, names, seqs = bench_read_set()
    rb = ReadBank(names, seqs)
    if args.cards == 4:
        phase_sharded(args.cards, rb)
    else:
        phase_xla_vs_cpu(rb)
        phase_golden(cli)
        phase_bench(cli, genome, rb)
        phase_ecoli(cli)
    print(result_line(dev, len(jax.devices())), flush=True)
    return 0


def result_line(dev, count):
    """The last line of standard output: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


if __name__ == "__main__":
    sys.exit(main())
