"""2-process DCN sharded overlap (jax.distributed over CPU).

The reference's cluster story is independent jobs with replicated
indexes (-P/-p, README-tools.md:112-117); ours is one global program
with the index sharded ACROSS processes (idx axis spans hosts,
parallel/multihost.py).  This test launches 2 real OS processes, each
with 4 virtual CPU devices, forms the (rd=4, idx=2) mesh across them,
and checks both return the identical pair set matching the single-chip
overlapper."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_dcn_overlap(tmp_path):
    nproc = 2
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs = []
    outs = []
    for pid in range(nproc):
        out = tmp_path / f"pairs_{pid}.txt"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "multihost_worker.py"),
             coordinator, str(nproc), str(pid), str(out)],
            cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fails = []
    for pid, pr in enumerate(procs):
        try:
            so, se = pr.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            pr.kill()
            so, se = pr.communicate()
            fails.append((pid, "timeout", se[-3000:]))
            continue
        if pr.returncode != 0:
            fails.append((pid, pr.returncode, se[-3000:]))
    assert not fails, f"worker failures: {fails}"

    pair_sets = []
    for out in outs:
        pair_sets.append({tuple(map(int, l.split())) for l in open(out)})
    assert pair_sets[0] == pair_sets[1], "processes disagree on the pair set"
    assert len(pair_sets[0]) > 50

    # same data through the single-chip overlapper (this process, CPU)
    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.pipeline.zmo import ZmoParams, overlap_dmo
    from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(77)
    genome = random_genome(rng, 60_000)
    names, seqs = simulate_reads(genome, coverage=8, mean_len=4000, err=0.12,
                                 seed=78)
    rb = ReadBank(names, seqs)
    one = overlap_dmo(rb, ZmoParams.dmo(ncand=64, batch_q=16), progress=False)
    single = {(min(o.rid1, o.rid2), max(o.rid1, o.rid2)) for o in one}
    jac = len(single & pair_sets[0]) / max(1, len(single | pair_sets[0]))
    assert jac >= 0.97, (f"multihost vs single-chip jaccard {jac:.4f} "
                         f"({len(pair_sets[0])} vs {len(single)})")
