"""Device-side alignment tracebacks (banded + refine state machine).

The round-3 tracebacks fetched the whole direction plane to the host
([B, LA, W] uint8 — 184 MB per 44-read consensus batch) and walked it
with a per-step numpy loop.  These kernels
walk the plane ON DEVICE with a lax.scan over backtrack steps and return
only the per-step move codes ([steps, B] int8, ~1 MB): the host then
run-length-encodes each read's move stream into a CIGAR with a handful
of numpy ops.

Semantics replicate ops/banded.py traceback_banded (moves DIAG/UP/LEFT,
out-of-band fallback to UP, semiglobal free leading gap) and
ops/refine.py traceback_refine (kswx.h:636-655 two-bit state machine)
exactly — the host wrappers assert this in the unit tests.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

DIAG, UP, LEFT, STOP = 1, 2, 3, 0


@functools.partial(jax.jit, static_argnames=("T",))
def tb_banded_device(dirs, base, alen, end_col, *, T: int):
    """Move codes for banded_align tracebacks; 0 = done/no-op."""
    B, LR, W = dirs.shape
    bidx = jnp.arange(B, dtype=jnp.int32)
    i0 = alen.astype(jnp.int32)
    j0 = end_col.astype(jnp.int32)

    def step(carry, _):
        i, j, done = carry
        ic = jnp.clip(i, 0, LR - 1)
        lane = j - base[bidx, ic]
        ok = (~done) & (lane >= 0) & (lane < W)
        mv = jnp.where(
            ok, dirs[bidx, ic, jnp.clip(lane, 0, W - 1)].astype(jnp.int32), 0)
        stuck = (~done) & (mv == 0)
        done = done | (stuck & (i <= 0))
        mv = jnp.where(stuck & (i > 0), UP, mv)
        mv = jnp.where(done, 0, mv)
        i = i - ((mv == DIAG) | (mv == UP)).astype(jnp.int32)
        j = j - ((mv == DIAG) | (mv == LEFT)).astype(jnp.int32)
        done = done | ((i <= 0) & (j <= 0))
        return (i, j, done), mv.astype(jnp.int8)

    done0 = (i0 <= 0) & (j0 <= 0)
    (i_f, j_f, _), mvs = jax.lax.scan(step, (i0, j0, done0), None, length=T)
    return mvs, j_f


@functools.partial(jax.jit, static_argnames=("T",))
def tb_refine_device(dirs, base, alen, blen, *, T: int):
    """Move codes for refine tracebacks; 3 = done/no-op (0=M, 1=I, 2=D)."""
    B, LR, W = dirs.shape
    bidx = jnp.arange(B, dtype=jnp.int32)
    i0 = alen.astype(jnp.int32)
    j0 = blen.astype(jnp.int32)

    def step(carry, _):
        i, j, state, done = carry
        ic = jnp.clip(i, 0, LR - 1)
        lane = j - base[bidx, ic]
        inband = (lane >= 0) & (lane < W)
        z = jnp.where(
            inband & ~done,
            dirs[bidx, ic, jnp.clip(lane, 0, W - 1)].astype(jnp.int32), 0)
        mv = (z >> (2 * state)) & 3
        mv = jnp.where(i <= 0, 2, mv)
        mv = jnp.where((j <= 0) & (i > 0), 1, mv)
        mv = jnp.where(done, 3, mv)
        i = i - ((mv == 0) | (mv == 1)).astype(jnp.int32)
        j = j - ((mv == 0) | (mv == 2)).astype(jnp.int32)
        state = jnp.where(mv == 3, state, mv)
        done = done | ((i <= 0) & (j <= 0))
        return (i, j, state, done), mv.astype(jnp.int8)

    done0 = (i0 <= 0) & (j0 <= 0)
    _, mvs = jax.lax.scan(
        step, (i0, j0, jnp.zeros_like(i0), done0), None, length=T)
    return mvs


def rle_moves(mv_col: np.ndarray, code2op, noop: int):
    """Reverse + run-length encode one read's move stream."""
    mv = mv_col[mv_col != noop][::-1]
    if mv.size == 0:
        return [], []
    cut = np.nonzero(np.diff(mv))[0]
    starts = np.concatenate([[0], cut + 1])
    ends = np.concatenate([cut + 1, [mv.size]])
    ops = [code2op[int(mv[s])] for s in starts]
    counts = [int(e - s) for s, e in zip(starts, ends)]
    return ops, counts
