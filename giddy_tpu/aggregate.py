"""Aggregate pushdown: exact sum/min/max without materializing the decode.

The DBMS scan-aggregate shape (the reference's MonetDB caller computed
aggregates over decoded columns host-side; here the aggregation fuses into
the decode). For the unpack-epilogue schemes (nbit, dzbf, for) one fused
program folds each slot vector into per-(group, lane) accumulators — the
column's decoded form never exists anywhere, only (ng, LANES) partials
(1/32 of the decoded elements) are written. Other schemes decode in-jit
and reduce with the same slot math in XLA.

Exactness: device vectors stay 32-bit, so 64-bit sums accumulate as
(lo, hi) uint32 pairs with explicit carries; signed columns additionally
count sign bits, and the true sum is ``S_unsigned - N_neg * 2**(8*w)``
(two's complement identity). Integer sums are exact Python ints. min/max
compare on monotone keys (bias-mapped ints, IEEE total-order floats), so
float min/max follows query.py's total-order semantics (NaNs at the
extremes). Float sums reduce host-side in float64 after a decode —
fusing a float sum onto 32-bit lanes would change the rounding story,
not just the speed.
"""

from __future__ import annotations

import numpy as np

from .format import EncodedColumn
from .util import GROUP, LANES, SLOTS, np_dtype, num_groups

import jax
import jax.numpy as jnp


def _key_map_traced(v, kind: str, itemsize: int):
    """uint32 payload -> monotone *signed int32* ordering key (traced).

    Keys are biased such that signed int32 compare gives the right order.
    """
    if kind == "i":
        vi = jax.lax.bitcast_convert_type(v, jnp.int32)
        if itemsize < 4:  # sign-extend narrow payloads
            k = 32 - 8 * itemsize
            vi = (vi << k) >> k
        return vi
    if kind == "f":
        # IEEE total order as unsigned: v ^ (0x80000000 | -(v>>31));
        # re-bias by another 0x80000000 so signed compare works.
        neg = jnp.uint32(0) - (v >> jnp.uint32(31))
        u = v ^ (jnp.uint32(0x80000000) | neg)
        return jax.lax.bitcast_convert_type(u ^ jnp.uint32(0x80000000), jnp.int32)
    # unsigned payload: flip sign bit, compare signed
    return jax.lax.bitcast_convert_type(v ^ jnp.uint32(0x80000000), jnp.int32)


def _key_unmap_host(key: int, dtype: str):
    """Inverse of _key_map_traced for one host-side int32 key."""
    dt = np_dtype(dtype)
    if dt.kind == "i":
        return int(key)
    u = np.int32(key).view(np.uint32) ^ np.uint32(0x80000000)  # undo bias
    if dt.kind == "f":
        if u >> np.uint32(31):  # was non-negative: clear the sign flip
            u = u ^ np.uint32(0x80000000)
        else:  # was negative: undo the full flip
            u = u ^ np.uint32(0xFFFFFFFF)
        return u.view(np.float32).item()
    return int(u)


def _slot_fold(slot_fn, pos_row, n: int, kind: str, itemsize: int, agg: str, shape, vw=None):
    """Shared slot loop: slot_fn(i) -> (R, LANES) uint32 payloads;
    pos_row = (R, LANES) int32 of each row's flat base position + lane.
    ``vw``: optional (R, LANES) uint32 validity words (LMP(1), nulls.py) —
    null rows drop out of the sum (min/max never need it: the canonical
    ffill only repeats valid values). Returns the accumulator stack for
    `agg` ('sum' -> (lo, hi, neg), 'min'/'max' -> keys)."""
    if agg == "sum":
        lo = jnp.zeros(shape, jnp.uint32)
        hi = jnp.zeros(shape, jnp.uint32)
        neg = jnp.zeros(shape, jnp.uint32)
        sh = jnp.uint32(8 * itemsize - 1)  # sign-bit position of the payload
        for i in range(SLOTS):
            v = slot_fn(i)
            valid = (pos_row + i * LANES) < n
            if vw is not None:
                valid = valid & (((vw >> jnp.uint32(i)) & jnp.uint32(1)) == jnp.uint32(1))
            v = jnp.where(valid, v, jnp.uint32(0))
            if kind == "i":
                neg = neg + ((v >> sh) & jnp.uint32(1))
            lo2 = lo + v
            hi = hi + (lo2 < lo).astype(jnp.uint32)  # carry out
            lo = lo2
        return lo, hi, neg
    init = jnp.int32(-(2**31)) if agg == "max" else jnp.int32(2**31 - 1)
    acc = jnp.full(shape, init)
    op = jnp.maximum if agg == "max" else jnp.minimum
    for i in range(SLOTS):
        v = _key_map_traced(slot_fn(i), kind, itemsize)
        valid = (pos_row + i * LANES) < n
        acc = op(acc, jnp.where(valid, v, init))
    return (acc,)


def _epilogue_agg_call(col: EncodedColumn, agg: str):
    """Fused unpack+aggregate for nbit/dzbf/for: slot vectors fold straight
    into (ng, LANES) partials, so the decoded column never materializes."""
    from . import nulls
    from .kernels.lanes import unpack_slot

    scheme = col.scheme
    bits = col.params["bits"] if scheme in ("nbit", "for") else 8 * col.params["width"]
    ng = num_groups(col.n)
    dt = np_dtype(col.dtype)
    kind, itemsize = dt.kind, dt.itemsize
    n = col.n
    with_valid = agg == "sum" and nulls.is_nullable(col)
    row = jax.lax.broadcasted_iota(jnp.int32, (ng, LANES), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (ng, LANES), 1)
    pos_row = row * GROUP + lane

    def call(streams, vw=None):
        x = streams["packed"]
        if x.dtype != jnp.uint32:
            x = jax.lax.bitcast_convert_type(x, jnp.uint32)
        ref = streams["refs_g"] if scheme == "for" else None

        def slot(i):
            v = unpack_slot(x, bits, i)
            return v + ref if ref is not None else v

        return _slot_fold(slot, pos_row, n, kind, itemsize, agg, (ng, LANES), vw=vw)

    if with_valid:
        return call
    return lambda streams: call(streams)


def _general_agg_fn(col: EncodedColumn, agg: str, with_valid: bool):
    """Decode-in-jit + slot-math reduce for every other scheme."""
    from .api import get_decoder

    ng = num_groups(col.n)
    dt = np_dtype(col.dtype)
    kind, itemsize = dt.kind, dt.itemsize
    n = col.n
    decoder = get_decoder(col)

    def fold(streams, vw):
        u = decoder(streams).reshape(ng, SLOTS, LANES)
        g = jax.lax.broadcasted_iota(jnp.int32, (ng, LANES), 0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (ng, LANES), 1)
        pos_row = g * GROUP + lane
        return _slot_fold(
            lambda i: u[:, i, :], pos_row, n, kind, itemsize, agg, (ng, LANES), vw=vw
        )

    if with_valid:
        return jax.jit(fold)
    return jax.jit(lambda streams: fold(streams, None))


_AGG_CACHE: dict[tuple, object] = {}


def _run(col: EncodedColumn, agg: str):
    from . import nulls
    from .api import device_streams
    from .util import check_device_addressable

    check_device_addressable(col.n, f"aggregate of {col.name!r}")
    # null rows must drop out of sums; min/max stay unmasked — the
    # canonical ffill only repeats valid values (nulls.py)
    with_valid = agg == "sum" and nulls.is_nullable(col)
    key = (col.static_key(), agg)
    fn = _AGG_CACHE.get(key)
    if fn is None:
        if col.scheme in ("nbit", "dzbf", "for"):
            fn = jax.jit(_epilogue_agg_call(col, agg))
        else:
            fn = _general_agg_fn(col, agg, with_valid)
        _AGG_CACHE[key] = fn
    if with_valid:
        return fn(device_streams(col), nulls.valid_words_device(col))
    return fn(device_streams(col))


def sum_(col: EncodedColumn) -> int | float:
    """Exact column sum. Integers return exact Python ints (64-bit-safe via
    (lo, hi, sign-count) accumulators); floats decode and reduce host-side
    in float64. Nullable columns sum the non-null rows (SQL SUM)."""
    from . import nulls

    dt = np_dtype(col.dtype)
    nullable = nulls.is_nullable(col)
    if col.scheme in ("cascade", "dict") and dt.kind != "f":
        # dict-domain pushdown: sum = sum_c count_c * dict_c — one device
        # pass over the CODES only (the value gather never runs), then an
        # exact O(dict_size) host dot in Python ints. Nullable: the valid
        # words ARE a filter bitmap, so null rows fall out of the counts.
        from .groupby import group_reduce, key_values

        bm = col.streams["valid"] if nullable else None
        counts = group_reduce(col, None, ("count",), bm).count
        vals = key_values(col).astype(np.int64)
        return int(sum(int(c) * int(v) for c, v in zip(counts, vals)))
    if dt.kind == "f":
        from .api import decode

        v = np.asarray(decode(col))
        if nullable:
            v = v[nulls.valid_mask(col)]
        return float(np.sum(v, dtype=np.float64))
    if col.scheme == "wide":
        from . import wide
        from .query import count_where

        s_lo = sum_(wide._sub(col, "lo"))
        s_hi = sum_(wide._sub(col, "hi"))
        s = s_lo + (s_hi << 32)
        if dt.kind == "i":  # two's complement: subtract 2^64 per negative
            n_neg = count_where(wide._sub(col, "hi"), "ge", 1 << 31)
            s -= n_neg << 64
        if nullable:
            # the plane sums covered the canonical fill values at null rows
            # too: subtract them exactly (partial.take decodes only the
            # groups that hold nulls)
            from .partial import take

            s -= sum(int(x) for x in take(col, nulls.null_positions(col)))
        return s
    lo, hi, neg = (np.asarray(a, dtype=np.uint64) for a in _run(col, "sum"))
    s = int(lo.sum()) + (int(hi.sum()) << 32)
    if dt.kind == "i":
        s -= int(neg.sum()) << (8 * dt.itemsize)
    return s


def _minmax(col: EncodedColumn, agg: str):
    # nullable columns need no masking here: the canonical ffill only
    # repeats valid values, so the filled extreme IS the valid extreme —
    # except when every row is null (no valid value exists at all)
    from . import nulls

    if col.n == 0:  # same contract as the all-null case: no valid rows
        raise ValueError(f"{agg} of an empty column")
    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        raise ValueError(f"{agg} of an all-null column")
    dt = np_dtype(col.dtype)
    if col.scheme in ("cascade", "dict") and col.params.get("dense"):
        # auto-built dictionary: every entry appears at least once, so the
        # column extreme is the dictionary extreme — host O(dict_size), no
        # decode at all (the dictionary twin of query.py's domain pushdown)
        from .query import _host_key_u32
        from .util import u32_to_dtype

        u = col.streams["values"].view(np.uint32)
        if dt.kind == "f":
            keys = _host_key_u32(u)
            pick = int(np.argmax(keys)) if agg == "max" else int(np.argmin(keys))
            return u32_to_dtype(u[pick : pick + 1], col.dtype)[0].item()
        vals = u32_to_dtype(u, col.dtype)
        return int(vals.max() if agg == "max" else vals.min())
    if col.scheme == "wide":
        # zone-map keys: logical values for ints, total-order bits for floats
        from .zonemap import zone_map

        zm = zone_map(col)
        k = zm.maxs.max() if agg == "max" else zm.mins.min()
        if dt.kind != "f":
            return int(k)
        u = np.uint64(k)
        if u >> np.uint64(63):
            u = u ^ np.uint64(0x8000000000000000)
        else:
            u = u ^ np.uint64(0xFFFFFFFFFFFFFFFF)
        return u.view(np.float64).item()
    (keys,) = _run(col, agg)
    k = np.asarray(keys)
    best = int(k.max()) if agg == "max" else int(k.min())
    return _key_unmap_host(best, col.dtype)


def avg_(col: EncodedColumn) -> float:
    """Column mean: exact sum / row count (float64). Nullable columns
    average the non-null rows (SQL AVG)."""
    from . import nulls

    nv = nulls.count_valid(col) if nulls.is_nullable(col) else col.n
    if nv == 0:
        raise ValueError("avg of an empty (or all-null) column")
    return float(sum_(col)) / nv


def distinct_count(col: EncodedColumn) -> int:
    """Number of distinct values (floats in bitpattern space: distinct NaN
    payloads count separately, matching the dictionary-build semantics).
    Dense (auto-built) cascade dictionaries answer O(1) from the header;
    other dictionary-backed columns count codes in use with a device code
    scan; everything else decodes and uniques host-side. Nullable columns
    count distinct non-null values (the ffill adds no new ones)."""
    from . import nulls

    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        return 0
    if col.scheme in ("cascade", "dict") and col.params.get("dense"):
        return col.params["dict_size"]
    if col.scheme in ("dict", "cascade"):
        from .groupby import group_count

        return int(np.count_nonzero(group_count(col).count))
    from .api import decode

    v = np.asarray(decode(col))
    if v.dtype.kind == "f":  # bitpattern distinctness (NaN payloads)
        v = v.view(np.uint64 if v.dtype.itemsize == 8 else np.uint32)
    return int(np.unique(v).size)


def min_(col: EncodedColumn):
    """Column minimum (floats: total-order semantics, NaN-aware)."""
    return _minmax(col, "min")


def max_(col: EncodedColumn):
    """Column maximum (floats: total-order semantics, NaN-aware)."""
    return _minmax(col, "max")
