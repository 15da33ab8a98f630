"""Checks that need the card: the overlap path compiled for the GPU
against the same code on the CPU, and the golden pair set on the GPU.

Run on the card with: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
(skipped elsewhere, see tests/conftest.py)."""

import os

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.gpu

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def test_overlap_batch_gpu_equals_cpu():
    """Index build, candidate scan, matcher and dot-matrix chain on one
    batch: every output array equal on GPU and CPU."""
    import __graft_entry__ as G

    fwd, args = G.entry()
    host = jax.device_get(args)
    gpu = jax.device_get(jax.jit(fwd)(*jax.device_put(host, jax.devices()[0])))
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = jax.device_get(jax.jit(fwd)(*jax.device_put(host, cpu_dev)))
    for a, b in zip(jax.tree_util.tree_leaves(gpu),
                    jax.tree_util.tree_leaves(cpu)):
        np.testing.assert_array_equal(a, b)


def test_golden_pairs_on_gpu():
    """Overlap pair set on the GPU == the reference binary's."""
    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.pipeline.zmo import ZmoParams, overlap_dmo

    rb = ReadBank.from_fasta(os.path.join(GOLD, "smoke.fa"))
    ovls = overlap_dmo(rb, ZmoParams.dmo(), progress=False)
    ours = {frozenset((rb.names[o.rid1], rb.names[o.rid2])) for o in ovls}
    ref = set()
    for line in open(os.path.join(GOLD, "smoke.ref.ovl")):
        c = line.split("\t")
        if len(c) > 5:
            ref.add(frozenset((c[0], c[5])))
    assert ours == ref
