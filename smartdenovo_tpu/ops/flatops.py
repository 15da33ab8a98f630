"""Flat-array primitives shared by the overlap kernels.

Design note: a per-slot binary search is log(n) dependent random
gathers, while sorted scatters and associative scans stream memory.
`expand_ranges` therefore maps output slots back to their source ranges
with one sorted scatter + a cummax forward-fill instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def expand_ranges(cnt: jnp.ndarray, budget: int):
    """Budgeted expansion of variable-length ranges.

    cnt: [N] int32 — number of items from each source.
    Returns (src [budget] int32 — source index per output slot (clipped),
             within [budget] int32 — offset of the slot inside its source,
             alive [budget] bool, total scalar).
    """
    cum = jnp.cumsum(cnt)
    total = cum[-1]
    starts = cum - cnt  # [N] sorted ascending
    n = cnt.shape[0]
    idx = jnp.where(cnt > 0, jnp.clip(starts, 0, budget), budget)
    mark = (
        jnp.zeros(budget + 1, jnp.int32)
        .at[idx]
        .max(jnp.arange(1, n + 1, dtype=jnp.int32), mode="drop")[:budget]
    )
    src = jax.lax.cummax(mark) - 1
    src_c = jnp.clip(src, 0, n - 1)
    p = jnp.arange(budget, dtype=jnp.int32)
    within = p - starts[src_c]
    alive = (p < total) & (src >= 0)
    return src_c, within, alive, total


def bounded_bisect(values: jnp.ndarray, probes: jnp.ndarray,
                   lo: jnp.ndarray, hi: jnp.ndarray, steps: int) -> jnp.ndarray:
    """Lower bound of probes within per-probe ranges [lo, hi) of `values`."""
    n = values.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mv = values[jnp.clip(mid, 0, n - 1)]
        go = (mv < probes) & (mid < hi)
        lo = jnp.where(go, mid + 1, lo)
        hi = jnp.where(go, hi, jnp.where(mid < hi, mid, hi))
    return lo
