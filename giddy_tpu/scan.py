"""Standalone scan/reduction ops (SURVEY.md §3.5: the reference's
``src/kernels/reduction`` standalone prefix-sum/reduce kernels).

These are the public, jittable versions of the utilities the decoders
use: per-group (tile-local) inclusive prefix sum, and a grouped
reduction. Both accept flat arrays of any length
(padded internally to GROUP tiles).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .kernels.lanes import group_cumsum
from .util import GROUP, num_groups


def group_prefix_sum(x, *, exclusive: bool = False):
    """Inclusive (or exclusive) prefix sum within each GROUP tile,
    wrapping uint32 — the backbone primitive of delta decode, exposed."""
    x = jnp.asarray(x)
    n = x.shape[0]
    ng = num_groups(n)
    pad = ng * GROUP - n
    xu = jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.uint32) if x.dtype != jnp.uint32 else x
    if pad:
        xu = jnp.concatenate([xu, jnp.zeros((pad,), jnp.uint32)])
    out = group_cumsum(xu.reshape(ng, GROUP)).reshape(-1)
    if exclusive:
        out = out - xu
    return out[:n]


def group_reduce(x, op: str = "sum"):
    """Per-GROUP reduction -> (num_groups,) array. ops: sum|max|min."""
    x = jnp.asarray(x)
    n = x.shape[0]
    ng = num_groups(n)
    pad = ng * GROUP - n
    if pad:
        info = np.iinfo(np.dtype(str(x.dtype)))
        fill = {"sum": 0, "max": info.min, "min": info.max}[op]
        x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
    x = x.reshape(ng, GROUP)
    return {"sum": jnp.sum, "max": jnp.max, "min": jnp.min}[op](x, axis=1)
