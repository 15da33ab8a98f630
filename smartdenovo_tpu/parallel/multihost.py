"""Multi-host (DCN) sharded overlap — N processes, idx axis across hosts.

The reference scales to clusters by running fully independent jobs per
node with a REPLICATED index (-P/-p, README-tools.md:112-117) and by
splitting the index into sequential passes when it exceeds one node's
memory (-G, wtzmo.c:1431-1463).  The device-native design does both at
once and keeps one global program:

  mesh (rd, idx) over ALL processes' devices, laid out so the idx axis
  spans processes: host h owns idx-shard block h.  Each process builds
  ONLY its own read-block index shards (1/H of the index per host — the
  -G memory division, but resident simultaneously instead of sequential
  passes), and the rd axis data-parallelizes query batches inside each
  host (the -P/-p split, but with exact cross-shard candidate merges
  over ICI/DCN collectives instead of replicated indexes).

Collective traffic per step (see sharded.sharded_overlap_step):
  all_gather over idx of per-shard top-A candidates  (DCN: Q*A int32)
  psum over idx of positional dot-matrix results      (DCN: 6*Q*A*2 int32)
Both ride the same compiled program as the single-process path — the
only multi-host-specific code is array assembly (every jax.Array is
built from process-local shards) and the global k16 frequency exchange
(process_allgather of per-shard (kmer, count) runs).

Entry points:
  init_multihost(coordinator, num_processes, process_id) — call first
  overlap_multihost(rb, params)  — every process returns the same full
                                   overlap list (emission is replayed
                                   identically everywhere)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.log import log
from .sharded import (ShardedBank, build_one_shard, filter_shard_k16,
                      k16_freq_rule, shard_bounds, shard_tier,
                      sharded_overlap_step)
from ..ops.flatseeds import pad_pow2


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   local_devices: int | None = None) -> None:
    """Initialize jax.distributed for a multi-process run.

    On CPU test rigs set local_devices to force
    --xla_force_host_platform_device_count (must run before jax device
    init).  On accelerator hosts the runtime discovers devices itself."""
    import os

    if local_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={local_devices}"
            ).strip()
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_dcn_mesh(n_idx: int | None = None) -> Mesh:
    """(rd, idx) mesh with the idx axis spanning processes.

    jax.devices() lists process 0's devices first; arranging the device
    grid as [i * rd + r] puts each process's devices in one idx column —
    every host owns exactly n_idx/H index shards and rd runs inside the
    host (collectives over rd ride ICI, only the idx all_gather/psum
    crosses DCN)."""
    devs = jax.devices()
    n = len(devs)
    H = jax.process_count()
    if n_idx is None:
        n_idx = H
    assert n % n_idx == 0, "device count must divide by idx shards"
    rd = n // n_idx
    grid = np.empty((rd, n_idx), dtype=object)
    for i in range(n_idx):
        for r in range(rd):
            grid[r, i] = devs[i * rd + r]
    return Mesh(grid, ("rd", "idx"))


def make_global(mesh: Mesh, spec: P, arr: np.ndarray) -> jax.Array:
    """Assemble a global jax.Array from a host-replicated numpy array.

    Each process device_puts only the slices its own devices hold; the
    result is a normal global array usable under jit with this mesh."""
    sharding = NamedSharding(mesh, spec)
    idx_map = sharding.addressable_devices_indices_map(arr.shape)
    bufs = [jax.device_put(arr[idx], d) for d, idx in idx_map.items()]
    return jax.make_array_from_single_device_arrays(arr.shape, sharding, bufs)


def _allgather_kmer_counts(uniq_local: np.ndarray, cnt_local: np.ndarray):
    """Exchange per-process k16 (kmer, count) runs; return global merge."""
    from jax.experimental import multihost_utils

    H = jax.process_count()
    if H == 1:
        return uniq_local, cnt_local
    # pad to the max local length (process_allgather needs equal shapes)
    n_local = np.array([len(uniq_local)], np.int64)
    n_all = np.asarray(multihost_utils.process_allgather(n_local)).reshape(-1)
    m = int(n_all.max())
    pk = np.full(m, 0xFFFFFFFF, np.uint32)
    pc = np.zeros(m, np.int64)
    pk[: len(uniq_local)] = uniq_local
    pc[: len(cnt_local)] = cnt_local
    gk = np.asarray(multihost_utils.process_allgather(pk)).reshape(H, m)
    gc = np.asarray(multihost_utils.process_allgather(pc)).reshape(H, m)
    ks, cs = [], []
    for h in range(H):
        ks.append(gk[h, : int(n_all[h])])
        cs.append(gc[h, : int(n_all[h])])
    allk = np.concatenate(ks)
    allc = np.concatenate(cs)
    uniq, inv = np.unique(allk, return_inverse=True)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(counts, inv, allc)
    return uniq, counts


def build_sharded_indexes_multihost(rb, p, mesh: Mesh) -> ShardedBank:
    """Per-process local shard build + global k16 frequency exchange.

    Unlike the single-process builder, a process never materializes
    another host's shard: host memory is 1/H of the index plus the
    (kmer, count) exchange buffers."""
    n = len(rb)
    S = mesh.devices.shape[1]
    bounds = shard_bounds(n, S)
    Ts = shard_tier(rb, bounds)
    Npad = pad_pow2(n, lo=1 << 8)
    sharding = NamedSharding(mesh, P("idx"))
    shard_devs = {}
    for d, idx in sharding.addressable_devices_indices_map((S, 1)).items():
        shard_devs.setdefault(idx[0].start, []).append(d)
    my_shards = sorted(shard_devs)
    log("multihost build: process %d/%d owns idx shards %s",
        jax.process_index(), jax.process_count(), my_shards)

    local = {}
    for s in my_shards:
        local[s] = build_one_shard(rb, p, bounds[s], bounds[s + 1], Ts, Npad)

    # ---- global k16 frequency counts across processes ----
    allk_local = (np.concatenate([local[s]["raw_k"] for s in my_shards])
                  if my_shards else np.zeros(0, np.uint32))
    uq_l, ct_l = np.unique(allk_local, return_counts=True)
    uniq, counts = _allgather_kmer_counts(uq_l, ct_l)
    keep_kmer = k16_freq_rule(counts, p.max_kmer_freq)

    # per-read global expansion need: local contribution, then psum-style
    # exchange (sum over processes)
    kneed_l = np.zeros(n, np.int64)
    bufs = {f: [] for f in ("kk", "krd", "kdr", "zsd", "zpk", "zrd", "rst")}
    for s in my_shards:
        sh = local[s]
        kk, krd, kdr = filter_shard_k16(sh, uniq, keep_kmer, Ts)
        ki = np.searchsorted(uniq, sh["raw_k"])
        ok = keep_kmer[ki]
        np.add.at(kneed_l, sh["raw_rd"][ok], counts[ki][ok])
        for d in shard_devs[s]:
            bufs["kk"].append(jax.device_put(kk[None], d))
            bufs["krd"].append(jax.device_put(krd[None], d))
            bufs["kdr"].append(jax.device_put(kdr[None], d))
            for f in ("zsd", "zpk", "zrd", "rst"):
                bufs[f].append(jax.device_put(sh[f][None], d))

    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        kneed_g = np.asarray(
            multihost_utils.process_allgather(kneed_l)
        ).reshape(jax.process_count(), n).sum(axis=0)
        # stats rows for all shards (emission needs per-shard masses)
        Sr = local[my_shards[0]]["stats"].shape[0] if my_shards else 0
        st_l = np.zeros((S, Sr), np.float64)
        for s in my_shards:
            st_l[s] = local[s]["stats"]
        stats = np.asarray(
            multihost_utils.process_allgather(st_l)
        ).reshape(jax.process_count(), S, Sr).sum(axis=0)
    else:
        kneed_g = kneed_l
        stats = np.stack([local[s]["stats"] for s in range(S)])

    def assemble(f):
        shape = (S,) + bufs[f][0].shape[1:]
        return jax.make_array_from_single_device_arrays(
            shape, sharding, bufs[f])

    return ShardedBank(
        k_kmers=assemble("kk"), k_rd=assemble("krd"), k_dir=assemble("kdr"),
        rm_zsd=assemble("zsd"), rm_pk=assemble("zpk"), rm_rd=assemble("zrd"),
        rm_start=assemble("rst"),
        bounds=bounds, stats=stats, kneed=kneed_g,
    )


def overlap_multihost(rb, params=None, mesh: Mesh | None = None,
                      progress: bool = True):
    """Multi-host overlap driver.  Every process runs the same global
    program and replays the same deterministic host emission, so each
    returns the identical full overlap list (callers typically write
    output only on process 0)."""
    from jax.experimental import multihost_utils

    from ..pipeline.zmo import (ZmoParams, _pad_tier, _extract_candidates_dm,
                                _replay_dm)
    from ..ops.seeds import extract_seeds

    p = params or ZmoParams.dmo()
    mesh = mesh or make_dcn_mesh()
    n_rd, n_idx = mesh.devices.shape
    n = len(rb)
    if n == 0:
        return []
    sb = build_sharded_indexes_multihost(rb, p, mesh)
    Npad = pad_pow2(n, lo=1 << 8)
    st = sb.stats
    zcnt = np.zeros(n, np.int64)
    kprobes = np.zeros(n, np.int64)
    cross = np.zeros(n, np.int64)
    for s in range(st.shape[0]):
        lo, hi = int(sb.bounds[s]), int(sb.bounds[s + 1])
        ln = hi - lo
        zcnt[lo:hi] = st[s, :ln]
        kprobes[lo:hi] = st[s, 2 * Npad: 2 * Npad + ln]
        cross[lo:hi] = st[s, 4 * Npad: 4 * Npad + ln]
    kneed = sb.kneed

    A = min(p.ncand, p.dm_cand) if p.dm_cand > 0 else p.ncand
    Qloc = max(1, p.batch_q // max(1, n_rd))
    Q = Qloc * n_rd
    Ltier = _pad_tier(int(rb.lengths.max()))
    read_lens = make_global(mesh, P(), rb.lengths.astype(np.int32))
    batches = [np.arange(n)[i: i + Q] for i in range(0, n, Q)]
    cbud = pad_pow2(max(int(kneed[b].sum()) for b in batches) + 1024,
                    lo=1 << 14)
    kq = pad_pow2(max(int(kprobes[b].sum()) for b in batches) + Q, lo=1 << 12)
    occ_budget = pad_pow2(max(int(zcnt[b].sum()) for b in batches) + Q,
                          lo=1 << 12)
    cross_budget = pad_pow2(2 * max(int(cross[b].sum()) for b in batches)
                            + 1024, lo=1 << 14)
    step = sharded_overlap_step(
        mesh, n_reads=n, Q=Q, A=A, kovl=p.kovl, len_ratio=p.len_ratio,
        ksave=p.ksave, cbud=cbud, kq=kq, occ_budget=occ_budget,
        cross_budget=cross_budget, nbk=max(cross_budget // 4, 1 << 14),
        kvar=p.kvar, zbits=2 * p.zsize, max_per_read=p.max_zmer_freq,
        nb=p.nb, xvar=p.xvar, yvar=p.yvar, min_block_len=p.min_block_len,
        max_overhang=p.max_overhang, deviation_penalty=p.deviation_penalty,
        gap_penalty=p.gap_penalty,
    )
    overlaps: list = []
    emitted_pairs: set = set()
    rdcovs = np.zeros(n, np.int64)
    rdmask = np.zeros(n, bool)
    avg_len = rb.avg_len()
    for b in batches:
        rids = np.concatenate(
            [b, np.full(Q - len(b), b[-1], b.dtype)]).astype(np.int32)
        qskip = np.zeros(Q, bool)
        qskip[len(b):] = True
        batch, lens = rb.batch(rids, pad_to=Ltier)
        # query seed extraction is device-side; replicate then reshard
        kres = extract_seeds(jnp.asarray(batch), jnp.asarray(lens),
                             p.ksize, p.hz)
        zres = extract_seeds(jnp.asarray(batch), jnp.asarray(lens),
                             p.zsize, p.hz)

        def mg(x, spec):
            return make_global(mesh, spec, np.asarray(x))

        csorted, packed, totals = step(
            mg(kres["kmer"], P("rd")), mg(kres["off"], P("rd")),
            mg(kres["span"], P("rd")), mg(kres["valid"], P("rd")),
            mg(zres["kmer"], P("rd")), mg(zres["off"], P("rd")),
            mg(zres["span"], P("rd")), mg(zres["dir"], P("rd")),
            mg(zres["valid"], P("rd")),
            mg(rids, P("rd")), mg(lens.astype(np.int32), P("rd")),
            mg(qskip, P("rd")), read_lens,
            sb.k_kmers, sb.k_rd, sb.k_dir,
            sb.rm_zsd, sb.rm_pk, sb.rm_rd, sb.rm_start,
        )
        # ---- per-host emission (VERDICT r4 weak #10) ----
        # each process extracts candidate records from its OWN query
        # rows (already local — no allgather of the full [6, Q*A*2]
        # pack), then the small candidate/attempted arrays are gathered
        # and every process replays the identical sequential acceptance.
        # DCN bytes per batch drop from O(Q*A) pack rows to O(accepted).
        csh = sorted(csorted.addressable_shards,
                     key=lambda s: s.index[0].start or 0)
        q_lo = min((s.index[0].start or 0) for s in csh)
        csorted_l = np.concatenate([np.asarray(s.data) for s in csh], axis=0)
        psh = sorted(packed.addressable_shards,
                     key=lambda s: s.index[1].start or 0)
        packed_l = np.concatenate([np.asarray(s.data) for s in psh], axis=1)
        totals_np = np.asarray(multihost_utils.process_allgather(
            totals, tiled=True))
        Qh = csorted_l.shape[0]
        NPl = Qh * A * 2
        row_l = np.concatenate([
            np.arange(NPl, dtype=np.int64),
            packed_l[0], packed_l[1], packed_l[2], packed_l[3], packed_l[4],
            packed_l[5],
            totals_np.max(axis=0).astype(np.int64),
        ])
        cand_l, att_l = _extract_candidates_dm(
            rb, p, rids[q_lo: q_lo + Qh], row_l, csorted_l, Qh, A,
            avg_len, q0=q_lo)
        if jax.process_count() > 1:
            cap = Qh * A
            cpad = np.full((cap, 11), -1, np.int64)
            cpad[: len(cand_l)] = cand_l
            apad = np.full((cap, 4), -1, np.int64)
            apad[: len(att_l)] = att_l
            call = np.asarray(multihost_utils.process_allgather(
                cpad, tiled=True)).reshape(-1, 11)
            aall = np.asarray(multihost_utils.process_allgather(
                apad, tiled=True)).reshape(-1, 4)
            cand_l = call[call[:, 0] >= 0]
            att_l = aall[aall[:, 0] >= 0]
            # restore the global sequential order (q asc, score desc)
            order = np.lexsort((-cand_l[:, 4], cand_l[:, 0]))
            cand_l = cand_l[order]
        _replay_dm(rb, p, cand_l, att_l, rdcovs, rdmask, overlaps,
                   emitted_pairs, set(), None, avg_len)
        if progress:
            log("multihost overlap %d/%d reads, %d overlaps",
                min(n, int(b[-1]) + 1), n, len(overlaps))
    return overlaps
