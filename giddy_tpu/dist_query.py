"""Distributed scans: predicate pushdown and aggregates over a device mesh.

Extends the new-scope multi-host dimension (SURVEY.md §3.11, CS-5) from
plain decode to the DBMS scan pipeline: each shard decodes its group range
with the same decoder `dist.py` uses and folds it locally into
1-bit match words or per-(group, lane) aggregate partials; GSPMD keeps
every fold shard-local because all reductions run along the unsharded
slot axis. The only cross-shard traffic is the final O(ng x 128)-word
result (host gather, or one all-reduce for scalar counts) — steady-state
scan bytes never cross NVLink or the network, preserving the linear-scaling story.

Pad positions (the ragged tail AND the whole groups added to round ng up
to the shard count) are masked inside the fold via a global position
iota, so they cannot contaminate counts, sums, or extrema.

Exactness matches the single-chip layer: integer sums via byte-plane
partials (32 slots x 255 < 2**13 per partial — int32-exact) plus sign
counts; min/max on aggregate.py's monotone keys; float sums finish
host-side in float64; 64-bit (wide) columns compose per 32-bit plane
(sums/counts) or answer from host zone maps (min/max, like aggregate)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .dist import build_sharded_decoder, default_mesh, dist_form
from .format import EncodedColumn
from .util import GROUP, LANES, SLOTS, cdiv, np_dtype, num_groups


def _nd(mesh, axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([mesh.shape[a] for a in axes]))


_SCAN_CACHE: dict[tuple, object] = {}


def _scan_fn(col: EncodedColumn, mesh, axis, mode: str, op: str | None):
    """Cached jitted fold over the sharded decode. mode: 'filter' (needs
    op; returns (ng_pad, LANES) match words), 'sum' (byte-plane + sign
    partials), 'min'/'max' (key partials)."""
    from .aggregate import _key_map_traced
    from .query import _cmp

    from .util import check_device_addressable

    check_device_addressable(col.n, f"sharded scan of {col.name!r}")
    key = (col.static_key(), mode, op, tuple(mesh.axis_names), mesh.devices.shape,
           axis if isinstance(axis, str) else tuple(axis))
    hit = _SCAN_CACHE.get(key)
    if hit is not None:
        return hit
    decode_fn, _ = build_sharded_decoder(col, mesh, axis)
    ng_pad = cdiv(num_groups(col.n), _nd(mesh, axis)) * _nd(mesh, axis)
    n = col.n
    dt = np_dtype(col.dtype)
    kind, itemsize = dt.kind, dt.itemsize

    def fold(val, vw, *dargs):
        # vw: group-sharded (ng_pad, LANES) validity words for nullable
        # columns (None otherwise) — the AND is shard-local, so the scan
        # stays collective-free
        x = decode_fn(*dargs).reshape(ng_pad, SLOTS, LANES)
        g = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 0)
        s = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 2)
        valid = (g * GROUP + s * LANES + lane) < n
        if vw is not None:
            bit = (vw[:, None, :] >> s.astype(jnp.uint32)) & jnp.uint32(1)
            valid = valid & (bit == jnp.uint32(1))
        if mode == "filter":
            hits = (_cmp(x, val[0, 0], op, kind, itemsize) & valid).astype(jnp.uint32)
            return jnp.sum(hits << s.astype(jnp.uint32), axis=1, dtype=jnp.uint32)
        if mode == "sum":
            v = jnp.where(valid, x, jnp.uint32(0))
            out = [
                jnp.sum((v >> jnp.uint32(8 * b)) & jnp.uint32(0xFF), axis=1, dtype=jnp.uint32)
                for b in range(itemsize)
            ]
            sh = jnp.uint32(8 * itemsize - 1)
            out.append(jnp.sum((v >> sh) & jnp.uint32(1), axis=1, dtype=jnp.uint32))
            return tuple(out)
        keys = _key_map_traced(x, kind, itemsize)
        init = jnp.int32(-(2**31)) if mode == "max" else jnp.int32(2**31 - 1)
        keys = jnp.where(valid, keys, init)
        red = jnp.max if mode == "max" else jnp.min
        return red(keys, axis=1)

    fn = jax.jit(fold)
    _SCAN_CACHE[key] = fn
    return fn


# Placed-argument cache: keyed by column identity (static_key alone would
# alias distinct columns with equal shapes/params but different data) and
# mesh configuration; holding the column keeps its id from being reused.
# Bounded LRU: derived columns (key codes, wide planes) memoize on their
# parents so repeats hit, but distinct columns must not accumulate device
# buffers forever — the oldest placement is dropped past the cap.
import collections as _collections

_ARGS_CACHE: "dict[tuple, tuple[EncodedColumn, object]]" = _collections.OrderedDict()
_ARGS_CACHE_MAX = 64


def _cache_put(key, value) -> None:
    _ARGS_CACHE[key] = value
    _ARGS_CACHE.move_to_end(key)
    while len(_ARGS_CACHE) > _ARGS_CACHE_MAX:
        _ARGS_CACHE.popitem(last=False)


def _cache_get(key):
    hit = _ARGS_CACHE.get(key)
    if hit is not None:
        _ARGS_CACHE.move_to_end(key)
    return hit


def _args(col, mesh, axis):
    """Sharded device placement of the column's streams, cached per
    (column identity, mesh) — repeated scans (or the several folds of one
    group_reduce_sharded) re-place nothing."""
    key = (id(col), tuple(mesh.axis_names), mesh.devices.shape,
           axis if isinstance(axis, str) else tuple(axis))
    hit = _cache_get(key)
    if hit is not None and hit[0] is col:
        return hit[1]
    _, args = build_sharded_decoder(col, mesh, axis)
    _cache_put(key, (col, args))
    return args


def _valid_arg(col, mesh, axis):
    """Group-sharded placement of a nullable column's validity words
    (padded to ng_pad like every sharded stream); None if not nullable."""
    from . import nulls
    from .dist import _pad_groups

    if not nulls.is_nullable(col):
        return None
    key = (id(col), "vw", tuple(mesh.axis_names), mesh.devices.shape,
           axis if isinstance(axis, str) else tuple(axis))
    hit = _cache_get(key)
    if hit is not None and hit[0] is col:
        return hit[1]
    from jax.sharding import NamedSharding, PartitionSpec as P

    ng = num_groups(col.n)
    ng_pad = cdiv(ng, _nd(mesh, axis)) * _nd(mesh, axis)
    vw = _pad_groups(col.streams["valid"], ng, ng_pad)
    dev = jax.device_put(vw, NamedSharding(mesh, P(axis, None)))
    _cache_put(key, (col, dev))
    return dev


def filter_bitmap_sharded(col: EncodedColumn, op: str, value, mesh=None, axis="d"):
    """Sharded twin of query.filter_bitmap: (ng, LANES) LMP(1) match words,
    group-sharded over the mesh, pad bits already zeroed (composable with
    the query.py bitmap algebra; no masking needed before counting)."""
    from .query import _OPS, _stage_value

    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    mesh = mesh or default_mesh(axis)
    if col.scheme == "wide":
        return _wide_filter_sharded(col, op, value, mesh, axis)
    fn = _scan_fn(col, mesh, axis, "filter", op)
    words = fn(jnp.asarray(_stage_value(col.dtype, value)),
               _valid_arg(col, mesh, axis), *_args(col, mesh, axis))
    return words[: num_groups(col.n)]


_COUNT_CACHE: dict[tuple, object] = {}


def count_where_sharded(col: EncodedColumn, op: str, value, mesh=None, axis="d") -> int:
    """Distributed predicate count: per-shard popcount partials, one scalar
    all-reduce (the scan's only collective)."""
    from .query import popcount_words

    words = filter_bitmap_sharded(col, op, value, mesh, axis)
    fn = _COUNT_CACHE.get("popcount")
    if fn is None:
        fn = _COUNT_CACHE["popcount"] = jax.jit(
            lambda x: jnp.sum(popcount_words(x), dtype=jnp.uint32)
        )
    return int(fn(words))


def _wide_filter_sharded(col, op, value, mesh, axis):
    """Wide columns: both planes decode sharded; the 64-bit compare pieces
    (hi, lo) halves exactly like query._wide_filter_fn."""
    from . import wide
    from .query import _stage_value_wide

    lo_col, hi_col = wide._sub(col, "lo"), wide._sub(col, "hi")
    kind = np_dtype(col.dtype).kind
    nd = _nd(mesh, axis)
    ng = num_groups(col.n)
    ng_pad = cdiv(ng, nd) * nd
    n = col.n
    key = (col.static_key(), "wide-filter", op, tuple(mesh.axis_names),
           mesh.devices.shape, axis if isinstance(axis, str) else tuple(axis))
    fn = _SCAN_CACHE.get(key)
    if fn is None:
        dlo, _ = build_sharded_decoder(lo_col, mesh, axis)
        dhi, _ = build_sharded_decoder(hi_col, mesh, axis)
        n_lo = len(_args(lo_col, mesh, axis))

        def fold(val, vw, *dargs):
            from .query import _wide_hits

            lo = dlo(*dargs[:n_lo]).reshape(ng_pad, SLOTS, LANES)
            hi = dhi(*dargs[n_lo:]).reshape(ng_pad, SLOTS, LANES)
            hits = _wide_hits(lo, hi, val[0, 0], val[0, 1], kind, op)
            g = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 0)
            s = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 1)
            lane = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 2)
            valid = (g * GROUP + s * LANES + lane) < n
            if vw is not None:  # nullable: shard-local validity AND
                bit = (vw[:, None, :] >> s.astype(jnp.uint32)) & jnp.uint32(1)
                valid = valid & (bit == jnp.uint32(1))
            hits = (hits & valid).astype(jnp.uint32)
            return jnp.sum(hits << s.astype(jnp.uint32), axis=1, dtype=jnp.uint32)

        fn = _SCAN_CACHE[key] = jax.jit(fold)
    val = jnp.asarray(_stage_value_wide(col.dtype, value))
    words = fn(val, _valid_arg(col, mesh, axis),
               *_args(lo_col, mesh, axis), *_args(hi_col, mesh, axis))
    return words[:ng]


def _isin_scan_fn(col, mesh, axis, m: int):
    """Cached jitted membership fold: sharded decode -> binary search of
    each payload in the replicated staged set (query._isin_searched's
    sharded twin; the table gather is shard-local, so no collectives)."""
    key = (col.static_key(), "isin", m, tuple(mesh.axis_names),
           mesh.devices.shape, axis if isinstance(axis, str) else tuple(axis))
    fn = _SCAN_CACHE.get(key)
    if fn is not None:
        return fn
    decode_fn, _ = build_sharded_decoder(col, mesh, axis)
    ng_pad = cdiv(num_groups(col.n), _nd(mesh, axis)) * _nd(mesh, axis)
    n = col.n

    def fold(table, vw, *dargs):
        x = decode_fn(*dargs).reshape(ng_pad, SLOTS, LANES)
        g = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 0)
        s = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 2)
        valid = (g * GROUP + s * LANES + lane) < n
        if vw is not None:
            bit = (vw[:, None, :] >> s.astype(jnp.uint32)) & jnp.uint32(1)
            valid = valid & (bit == jnp.uint32(1))
        u = x.reshape(-1)
        pos = jnp.clip(jnp.searchsorted(table, u), 0, m - 1)
        hit = (table[pos] == u).reshape(ng_pad, SLOTS, LANES)
        hits = (hit & valid).astype(jnp.uint32)
        return jnp.sum(hits << s.astype(jnp.uint32), axis=1, dtype=jnp.uint32)

    fn = _SCAN_CACHE[key] = jax.jit(fold)
    return fn


def _isin_wide_fn(col, mesh, axis, m: int):
    """Wide twin: both planes decode sharded, (hi, lo) pairs lower-bound
    the lexicographically sorted staged set in log2(m) branchless steps
    (query._isin_searched_wide's sharded twin)."""
    from . import wide

    key = (col.static_key(), "isin_wide", m, tuple(mesh.axis_names),
           mesh.devices.shape, axis if isinstance(axis, str) else tuple(axis))
    fn = _SCAN_CACHE.get(key)
    if fn is not None:
        return fn
    lo_col, hi_col = wide._sub(col, "lo"), wide._sub(col, "hi")
    dlo, _ = build_sharded_decoder(lo_col, mesh, axis)
    dhi, _ = build_sharded_decoder(hi_col, mesh, axis)
    n_lo = len(_args(lo_col, mesh, axis))
    ng_pad = cdiv(num_groups(col.n), _nd(mesh, axis)) * _nd(mesh, axis)
    n = col.n

    def fold(tlo, thi, vw, *dargs):
        lo = dlo(*dargs[:n_lo]).reshape(ng_pad, SLOTS, LANES)
        hi = dhi(*dargs[n_lo:]).reshape(ng_pad, SLOTS, LANES)
        pos = jnp.zeros(lo.shape, jnp.int32)
        step = m >> 1
        while step:  # static unroll: branchless lexicographic lower-bound
            cand = pos + step
            chi, clo = thi[cand], tlo[cand]
            le = (chi < hi) | ((chi == hi) & (clo <= lo))
            pos = jnp.where(le, cand, pos)
            step >>= 1
        hit = (thi[pos] == hi) & (tlo[pos] == lo)
        g = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 0)
        s = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 2)
        valid = (g * GROUP + s * LANES + lane) < n
        if vw is not None:
            bit = (vw[:, None, :] >> s.astype(jnp.uint32)) & jnp.uint32(1)
            valid = valid & (bit == jnp.uint32(1))
        hits = (hit & valid).astype(jnp.uint32)
        return jnp.sum(hits << s.astype(jnp.uint32), axis=1, dtype=jnp.uint32)

    fn = _SCAN_CACHE[key] = jax.jit(fold)
    return fn


def isin_bitmap_sharded(col: EncodedColumn, values, mesh=None, axis="d"):
    """Sharded twin of query.isin_bitmap: ONE staged-set search scan over
    the mesh (no eq-OR small-set special case — a single compiled kernel
    per (column, set-size-bucket) is the right trade at fleet scale).
    Floats match in bitpattern space; wide columns search both planes."""
    mesh = mesh or default_mesh(axis)
    ng = num_groups(col.n)
    from .query import _staged_set_u32, _staged_set_u64

    if col.scheme == "wide":
        from . import wide

        staged = _staged_set_u64(col.dtype, values)
        if staged is None:
            return jnp.zeros((ng, LANES), jnp.uint32)
        slo, shi = staged
        fn = _isin_wide_fn(col, mesh, axis, slo.size)
        lo_col, hi_col = wide._sub(col, "lo"), wide._sub(col, "hi")
        words = fn(jnp.asarray(slo), jnp.asarray(shi),
                   _valid_arg(col, mesh, axis),
                   *_args(lo_col, mesh, axis), *_args(hi_col, mesh, axis))
        return words[:ng]
    if np_dtype(col.dtype).kind == "f":
        fv = np.asarray(np.asarray(values, dtype=object).reshape(-1), np.float32)
        vals = [int(x) for x in np.unique(fv.view(np.uint32))]
    else:
        vals = [int(v) for v in np.asarray(values).reshape(-1)]
    staged = _staged_set_u32(col.dtype, vals) if vals else None
    if staged is None:
        return jnp.zeros((ng, LANES), jnp.uint32)
    fn = _isin_scan_fn(col, mesh, axis, staged.size)
    words = fn(jnp.asarray(staged), _valid_arg(col, mesh, axis),
               *_args(col, mesh, axis))
    return words[:ng]


def isin_count_sharded(col: EncodedColumn, values, mesh=None, axis="d") -> int:
    """Distributed membership count (one scalar reduce, like
    count_where_sharded)."""
    from .query import popcount_words

    words = isin_bitmap_sharded(col, values, mesh, axis)
    fn = _COUNT_CACHE.get("popcount")
    if fn is None:
        fn = _COUNT_CACHE["popcount"] = jax.jit(
            lambda x: jnp.sum(popcount_words(x), dtype=jnp.uint32)
        )
    return int(fn(words))


def semi_join_bitmap_sharded(probe: EncodedColumn, build: EncodedColumn,
                             mesh=None, axis="d"):
    """Sharded semi-join bitmap: probe rows whose value appears in the
    build column (Table.semi_join's mesh twin). The build side's distinct
    set is computed host-side (its dictionary when it has one); the probe
    scan is the sharded membership search. strdict probes rewrite to a
    code-set scan on their inner code column (validity propagates)."""
    from .table import _distinct_values

    mesh = mesh or default_mesh(axis)
    vals = _distinct_values(build)
    if probe.scheme == "strdict":
        from .strings import code_set, codes_column

        return isin_bitmap_sharded(codes_column(probe), code_set(probe, vals),
                                   mesh, axis)
    return isin_bitmap_sharded(probe, vals, mesh, axis)


def sum_sharded(col: EncodedColumn, mesh=None, axis="d") -> int | float:
    """Distributed exact column sum (semantics of aggregate.sum_, incl.
    null-skipping for nullable columns)."""
    from . import nulls

    mesh = mesh or default_mesh(axis)
    dt = np_dtype(col.dtype)
    nullable = nulls.is_nullable(col)
    if col.scheme in ("cascade", "dict") and dt.kind != "f":
        # dict-domain pushdown, sharded: count codes on the mesh, exact
        # O(dict_size) host dot (twin of aggregate.sum_'s dictionary path;
        # group_reduce_sharded drops null rows from the counts itself)
        from .groupby import key_values

        counts = group_reduce_sharded(col, None, ("count",), mesh=mesh, axis=axis).count
        vals = key_values(col).astype(np.int64)
        return int(sum(int(c) * int(v) for c, v in zip(counts, vals)))
    if dt.kind == "f":
        from .dist import decode_sharded

        v = np.asarray(decode_sharded(col, mesh, axis))
        if nullable:
            v = v[nulls.valid_mask(col)]
        return float(np.sum(v, dtype=np.float64))
    if col.scheme == "wide":
        from . import wide

        s_lo = _plane_sum_sharded(wide._sub(col, "lo"), mesh, axis)
        hi = wide._sub(col, "hi")
        s_hi = _plane_sum_sharded(hi, mesh, axis)
        s = s_lo + (s_hi << 32)
        if dt.kind == "i":
            s -= count_where_sharded(hi, "ge", 1 << 31, mesh, axis) << 64
        if nullable:
            # plane sums covered the fill values at null rows: subtract
            # them exactly (aggregate.sum_'s wide correction)
            from .partial import take

            s -= sum(int(x) for x in take(col, nulls.null_positions(col)))
        return s
    fn = _scan_fn(col, mesh, axis, "sum", None)
    parts = fn(None, _valid_arg(col, mesh, axis), *_args(col, mesh, axis))
    w = dt.itemsize
    s = sum(int(np.asarray(parts[b], np.int64).sum()) << (8 * b) for b in range(w))
    if dt.kind == "i":
        s -= int(np.asarray(parts[w], np.int64).sum()) << (8 * w)
    return s


def _plane_sum_sharded(plane_col, mesh, axis) -> int:
    fn = _scan_fn(plane_col, mesh, axis, "sum", None)
    parts = fn(None, None, *_args(plane_col, mesh, axis))
    return sum(int(np.asarray(parts[b], np.int64).sum()) << (8 * b) for b in range(4))


def _minmax_sharded(col, agg, mesh, axis):
    from . import nulls
    from .aggregate import _key_unmap_host, _minmax

    if col.n == 0:
        raise ValueError(f"{agg} of an empty column")
    if nulls.is_nullable(col) and nulls.count_valid(col) == 0:
        raise ValueError(f"{agg} of an all-null column")
    if col.scheme == "wide" or (
        col.scheme in ("cascade", "dict") and col.params.get("dense")
    ):
        # wide answers from host zone maps; dense dictionaries from the
        # dictionary itself — neither touches the mesh (aggregate._minmax).
        # No null masking needed: the canonical ffill only repeats valid
        # values (nulls.py).
        return _minmax(col, agg)
    mesh = mesh or default_mesh(axis)
    fn = _scan_fn(col, mesh, axis, agg, None)
    keys = np.asarray(fn(None, None, *_args(col, mesh, axis)))
    best = int(keys.max()) if agg == "max" else int(keys.min())
    return _key_unmap_host(best, col.dtype)


def min_sharded(col: EncodedColumn, mesh=None, axis="d"):
    """Distributed column minimum (float semantics: total order)."""
    return _minmax_sharded(col, "min", mesh, axis)


def max_sharded(col: EncodedColumn, mesh=None, axis="d"):
    """Distributed column maximum (float semantics: total order)."""
    return _minmax_sharded(col, "max", mesh, axis)


# --- distributed GROUP BY ---------------------------------------------------


def _gb_fold(keys, vals, mesh, axis, *, want_count, sum_bytes, want_neg,
             want_minmax, has_bitmap, val_kind="u", val_itemsize=4):
    """Sharded twin of groupby._build_device_fn: decode codes (+measure)
    via the sharded decoders, fold into per-key segment partials under
    GSPMD. Segment outputs are O(d) — the only cross-shard traffic."""
    from .aggregate import _key_map_traced
    from .groupby import CHUNK_GROUPS, _codes_device_column

    from .util import check_device_addressable

    check_device_addressable(keys.n, "sharded group_reduce")
    key = ("gb", keys.static_key(), vals.static_key() if vals is not None else None,
           (want_count, sum_bytes, want_neg, want_minmax, has_bitmap, CHUNK_GROUPS),
           tuple(mesh.axis_names), mesh.devices.shape,
           axis if isinstance(axis, str) else tuple(axis))
    hit = _SCAN_CACHE.get(key)
    if hit is not None:
        return hit
    d = keys.params["dict_size"]
    n = keys.n
    ng = num_groups(n)
    ng_pad = cdiv(ng, _nd(mesh, axis)) * _nd(mesh, axis)
    nchunks = cdiv(ng_pad, CHUNK_GROUPS)
    ccol = _codes_device_column(keys)
    kdec, _ = build_sharded_decoder(ccol, mesh, axis)
    n_kargs = len(_args(ccol, mesh, axis))
    vdec = build_sharded_decoder(vals, mesh, axis)[0] if vals is not None else None

    def fold(bm, *dargs):
        codes = jax.lax.bitcast_convert_type(
            kdec(*dargs[:n_kargs]), jnp.int32
        ).reshape(ng_pad, SLOTS, LANES)
        g = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 0)
        s = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (ng_pad, SLOTS, LANES), 2)
        valid = (g * GROUP + s * LANES + lane) < n
        if bm is not None:
            bm_p = jnp.pad(bm, ((0, ng_pad - bm.shape[0]), (0, 0)))
            bit = (bm_p[:, None, :] >> s.astype(jnp.uint32)) & jnp.uint32(1)
            valid = valid & (bit == jnp.uint32(1))
        seg = jnp.where(valid, codes, jnp.int32(d)).reshape(-1)
        out = {}
        if want_count:
            out["count"] = jax.ops.segment_sum(
                jnp.ones((ng_pad * GROUP,), jnp.uint32), seg, num_segments=d + 1
            )
        if vdec is not None:
            v = vdec(*dargs[n_kargs:]).reshape(-1)
            if sum_bytes:
                cseg = (g // CHUNK_GROUPS).reshape(-1) * (d + 1) + seg
                for b in range(sum_bytes):
                    out[f"b{b}"] = jax.ops.segment_sum(
                        (v >> jnp.uint32(8 * b)) & jnp.uint32(0xFF),
                        cseg, num_segments=nchunks * (d + 1),
                    )
            if want_neg:
                sign = (v >> jnp.uint32(8 * val_itemsize - 1)) & jnp.uint32(1)
                out["neg"] = jax.ops.segment_sum(sign, seg, num_segments=d + 1)
            if want_minmax:
                k = _key_map_traced(v, val_kind, val_itemsize)
                out["min"] = jax.ops.segment_min(k, seg, num_segments=d + 1)
                out["max"] = jax.ops.segment_max(k, seg, num_segments=d + 1)
        return out

    fn = jax.jit(fold)
    _SCAN_CACHE[key] = fn
    return fn


def _gb_run(keys, vals, bitmap, mesh, axis, **flags):
    from .groupby import _codes_device_column

    fn = _gb_fold(keys, vals, mesh, axis, has_bitmap=bitmap is not None, **flags)
    dargs = list(_args(_codes_device_column(keys), mesh, axis))
    if vals is not None:
        dargs += list(_args(vals, mesh, axis))
    bm = jnp.asarray(bitmap) if bitmap is not None else None
    out = fn(bm, *dargs)
    return {k: np.asarray(a) for k, a in out.items()}


def group_reduce_sharded(keys, vals=None, aggs=("count",), bitmap=None,
                         mesh=None, axis="d"):
    """Distributed groupby.group_reduce: same semantics and GroupResult
    (incl. excluding rows with a null key or measure), with codes and
    measures decoding sharded over the mesh. Float sums and wide min/max
    decode sharded, then finish host-side (like the single-chip layer);
    everything else stays on device."""
    from . import groupby as gb

    bitmap = gb._and_validity(bitmap, keys, vals)
    mesh = mesh or default_mesh(axis)
    aggs = tuple(aggs)
    for a in aggs:
        if a not in gb._AGGS:
            raise ValueError(f"agg must be one of {gb._AGGS}, got {a!r}")
    need_vals = any(a != "count" for a in aggs)
    if need_vals and vals is None:
        raise ValueError("sum/min/max require a values column")
    if vals is not None and vals.n != keys.n:
        raise ValueError(f"length mismatch: keys n={keys.n}, vals n={vals.n}")
    if keys.scheme not in ("dict", "cascade", "strdict"):
        gb._codes_device_column(keys)  # raises the explanatory ValueError

    d = keys.params["dict_size"]
    kv = gb.key_values(keys)
    vdt = np_dtype(vals.dtype) if vals is not None else None
    want_sum = "sum" in aggs
    want_minmax = ("min" in aggs) or ("max" in aggs)
    res = gb.GroupResult(keys=kv, count=None)

    def _host_mask():
        return gb._host_mask(keys.n, np.asarray(bitmap)) if bitmap is not None else None

    if vals is not None and vals.scheme == "wide":
        from . import wide

        res.count = _gb_run(keys, None, bitmap, mesh, axis, want_count=True,
                            sum_bytes=0, want_neg=False, want_minmax=False)["count"][:d].astype(np.int64)
        if want_sum and vdt.kind == "f":
            # float64 planes sum as bitpatterns only losslessly via a
            # decode: finish host-side in float64 (aggregate.sum_ stance)
            from .dist import decode_sharded

            codes = gb._codes_host(keys)
            v = np.asarray(decode_sharded(vals, mesh, axis))
            res.sum = gb._host_group_sum_float(codes, v, d, _host_mask())
        elif want_sum:
            lo_p = _gb_run(keys, wide._sub(vals, "lo"), bitmap, mesh, axis,
                           want_count=False, sum_bytes=4, want_neg=False, want_minmax=False)
            hi_p = _gb_run(keys, wide._sub(vals, "hi"), bitmap, mesh, axis,
                           want_count=False, sum_bytes=4, want_neg=vdt.kind == "i",
                           want_minmax=False)
            lo_s = gb._finish_sum(lo_p, d, 4, signed=False)
            hi_s = gb._finish_sum(hi_p, d, 4, signed=False)
            total = [int(lo) + (int(h) << 32) for lo, h in zip(lo_s, hi_s)]
            if vdt.kind == "i":
                neg = hi_p["neg"][:d].astype(np.int64)
                total = [t - (int(nn) << 64) for t, nn in zip(total, neg)]
            res.sum = np.array(total, dtype=object)
        if want_minmax:
            from .dist import decode_sharded

            codes = gb._codes_host(keys)
            v = np.asarray(decode_sharded(vals, mesh, axis))
            mn, mx = gb._host_group_minmax(codes, v, d, _host_mask())
            if "min" in aggs:
                res.min = mn
            if "max" in aggs:
                res.max = mx
        return res

    flags = dict(want_count=True, sum_bytes=0, want_neg=False, want_minmax=False)
    if vals is not None:
        flags["val_kind"] = vdt.kind
        flags["val_itemsize"] = vdt.itemsize
        if want_sum and vdt.kind != "f":
            flags["sum_bytes"] = vdt.itemsize
            flags["want_neg"] = vdt.kind == "i"
        if want_minmax:
            flags["want_minmax"] = True
    out = _gb_run(keys, vals if need_vals else None, bitmap, mesh, axis, **flags)
    res.count = out["count"][:d].astype(np.int64)
    if vals is not None and want_sum:
        if vdt.kind == "f":
            from .dist import decode_sharded

            codes = gb._codes_host(keys)
            v = np.asarray(decode_sharded(vals, mesh, axis))
            res.sum = gb._host_group_sum_float(codes, v, d, _host_mask())
        else:
            res.sum = gb._finish_sum(out, d, vdt.itemsize, vdt.kind == "i")
    if vals is not None and want_minmax:
        if "min" in aggs:
            res.min = gb._unmap_keys_host(out["min"][:d], vals.dtype)
        if "max" in aggs:
            res.max = gb._unmap_keys_host(out["max"][:d], vals.dtype)
    return res
