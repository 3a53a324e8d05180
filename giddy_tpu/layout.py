"""Data-layout + set-representation ops (SURVEY.md §3.3–3.4).

Upstream analogs: libgiddy ``src/kernels/data_layout/gather.cuh`` /
``scatter.cuh`` (building blocks of DICT decode and patching) and the
``set_representation`` kernels (dense-bitmap <-> sparse-index-list
conversions around incidence bitmaps and patch positions).

These are jittable, shard_map-compatible functions over device arrays; the
NumPy twins (`*_np`) serve the oracle/tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ref.lmp import lmp_pack, lmp_unpack


def gather(data: jax.Array, idx: jax.Array) -> jax.Array:
    """out[i] = data[idx[i]] (libgiddy gather.cuh)."""
    return jnp.take(data, idx, axis=0)


def scatter(out: jax.Array, idx: jax.Array, vals: jax.Array) -> jax.Array:
    """out[idx[i]] = vals[i] (libgiddy scatter.cuh); functional update."""
    return out.at[idx].set(vals)


def bitmap_to_indices(bits: jax.Array, max_count: int) -> tuple[jax.Array, jax.Array]:
    """Dense 0/1 vector -> (indices, count), fixed-size output.

    Vector-shaped compaction: rank = exclusive cumsum of the mask; index j
    lands at slot rank[j]. Slots >= count hold len(bits) (a sentinel).
    """
    n = bits.shape[0]
    mask = bits != 0
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    count = jnp.sum(mask.astype(jnp.int32))
    pos = jnp.arange(n, dtype=jnp.int32)
    idx = jnp.full((max_count,), n, dtype=jnp.int32)
    # non-set positions scatter to index max_count — out of bounds, dropped
    idx = idx.at[jnp.where(mask, rank, max_count)].set(
        jnp.where(mask, pos, n), mode="drop"
    )
    return idx, count


def indices_to_bitmap(idx: jax.Array, n: int) -> jax.Array:
    """Sparse index list -> dense 0/1 uint32 vector (out-of-range dropped)."""
    out = jnp.zeros((n,), dtype=jnp.uint32)
    return out.at[idx].set(jnp.uint32(1), mode="drop")


def bitmap_to_indices_np(bits: np.ndarray) -> np.ndarray:
    return np.nonzero(bits)[0].astype(np.int32)


def indices_to_bitmap_np(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.uint32)
    out[idx] = 1
    return out


def pack_bitmap_np(bits: np.ndarray) -> np.ndarray:
    """Dense 0/1 vector -> LMP(1) words (the incidence-bitmap plane layout)."""
    return lmp_pack(bits.astype(np.uint32), 1)


def unpack_bitmap_np(words: np.ndarray, n: int) -> np.ndarray:
    return lmp_unpack(words, 1, n)
