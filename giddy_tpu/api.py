"""Public decode API: the analog of libgiddy call stack CS-2 (SURVEY.md §4).

``decode(col)``:  factory lookup → (cached) jit specialization → device
streams → XLA decode → logical-dtype array. Decoders are cached by
the column's static key, mirroring the reference's
name→instantiated-kernel factory.
"""

from __future__ import annotations

import jax
import numpy as np

from . import kernels as _kernels  # noqa: F401  (installs device decoders)
from . import ref as _ref  # noqa: F401  (installs CPU codecs)
from . import strings as _strings  # noqa: F401  (installs the string-dictionary scheme)
from . import wide as _wide  # noqa: F401  (installs the 64-bit plane wrapper)
from . import registry
from .format import EncodedColumn
from .util import np_dtype

_DECODER_CACHE: dict[tuple, object] = {}


def encode(values: np.ndarray, scheme: str, *, valid=None, **opts) -> EncodedColumn:
    """Host-side encode (NumPy oracle codec; encode is out of the hot path
    by design — SURVEY.md §1 'decode-only').

    ``scheme="auto"`` routes through the advisor (trial encodes on a
    sample, best ratio wins — advisor.encode_best).

    ``valid``: optional bool[n] mask (True = non-null) making the column
    nullable — null slots are canonically filled (previous valid value)
    before encoding and a ``valid`` LMP(1) stream is attached; see
    nulls.py for the scan/aggregate semantics this buys."""
    if scheme == "auto":
        from .advisor import encode_best

        if valid is not None:
            from . import nulls

            mask = np.asarray(valid, bool)
            filled = nulls.fill_nulls(np.asarray(values), mask)
            return nulls.attach_valid(encode_best(filled, **opts), mask)
        return encode_best(np.asarray(values), **opts)
    if valid is not None:
        from . import nulls

        mask = np.asarray(valid, bool)
        filled = nulls.fill_nulls(np.asarray(values), mask)
        return nulls.attach_valid(registry.get(scheme).encode(filled, **opts), mask)
    return registry.get(scheme).encode(values, **opts)


def decode_ref(col: EncodedColumn) -> np.ndarray:
    """CPU oracle decode — the bit-exactness reference."""
    return registry.get(col.scheme).decode_ref(col)


def get_decoder(col: EncodedColumn, out_store=None):
    """Build (or fetch cached) the jitted device decoder for this column's
    static configuration. Returns fn(streams_device) -> uint32[n_pad].

    ``out_store`` (jnp.uint8/jnp.uint16, schemes with Codec.narrow_store):
    the decoder stores at storage width instead — 1/4 or 1/2 the output
    HBM traffic for int8/int16 columns. Every fused-scan caller (query/
    aggregate/topk/dist) omits it and keeps the uint32 payload contract."""
    from .util import check_device_addressable

    check_device_addressable(col.n, f"device decode of {col.name!r}")
    key = (col.static_key(), out_store and np.dtype(out_store).name)
    fn = _DECODER_CACHE.get(key)
    if fn is None:
        builder = registry.get(col.scheme).decode_device
        if builder is None:
            raise NotImplementedError(f"no device decoder for {col.scheme!r}")
        fn = jax.jit(builder(col, out_store=out_store) if out_store else builder(col))
        _DECODER_CACHE[key] = fn
    return fn


def narrow_store_dtype(col: EncodedColumn):
    """The storage-width store dtype full-column decode should use for this
    column, or None (32-bit columns; schemes without narrow_store). The
    reference specialized kernels on the element type template-side
    (SURVEY.md §3.1); here the jit cache key plays that role."""
    import jax.numpy as jnp

    if col.dtype not in ("int8", "uint8", "int16", "uint16"):
        return None
    dt = np_dtype(col.dtype)
    if not registry.get(col.scheme).narrow_store:
        return None
    return jnp.uint8 if dt.itemsize == 1 else jnp.uint16


def device_streams(col: EncodedColumn) -> dict[str, jax.Array]:
    from .kernels.common import to_device_streams

    prep = registry.get(col.scheme).prep_streams
    streams = prep(col) if prep is not None else col.streams
    return to_device_streams(streams)


def _decode_chunked(col: EncodedColumn, *, pad: bool) -> np.ndarray:
    """Transparent big-column decode (the libgiddy ``IndexSize`` analog,
    SURVEY.md §3.1): columns whose padded length exceeds the int32 device
    addressing limit decode in group chunks via partial.GroupSlicer —
    each chunk is an independent device call, results assemble on the host
    (a >8 GiB decoded column would not fit one device buffer anyway)."""
    from . import util
    from .partial import GroupSlicer
    from .util import GROUP, num_groups

    if col.scheme == "wide":  # chunk each 32-bit plane, recombine on host
        from . import wide

        lo = _decode_chunked(wide._sub(col, "lo"), pad=pad)
        hi = _decode_chunked(wide._sub(col, "hi"), pad=pad)
        return wide._combine(lo.view(np.uint32), hi.view(np.uint32), col.dtype)
    ng = num_groups(col.n)
    chunk = max(1, (util.MAX_DEVICE_ELEMS // GROUP) // 2)
    slicer = GroupSlicer(col)
    parts = [slicer.decode(g0, min(g0 + chunk, ng)) for g0 in range(0, ng, chunk)]
    out = np.concatenate(parts)
    if pad:
        out = np.pad(out, (0, ng * GROUP - col.n))
    return out


def decode(col: EncodedColumn, *, pad: bool = False):
    """Decode a column on the default device. Returns the logical-dtype
    array of length n (or n_pad when pad=True, avoiding the final slice).
    64-bit (``wide``) columns come back as NumPy (planes decode on-device,
    the int64 recombine happens at the host boundary — see wide.py).
    Columns beyond the 2**31-element single-call addressing limit decode
    transparently in group chunks (host-assembled NumPy result)."""
    from . import util
    from .util import GROUP, num_groups

    if col.scheme != "strdict" and num_groups(col.n) * GROUP >= util.MAX_DEVICE_ELEMS:
        return _decode_chunked(col, pad=pad)
    if col.scheme == "wide":
        from . import wide

        return wide.decode_device(col, pad=pad)
    if col.scheme == "strdict":
        from . import strings

        return strings.decode(col)  # codes on device, string gather host-side
    u = get_decoder(col, narrow_store_dtype(col))(device_streams(col))
    out = _to_logical(u, col.dtype)
    return out if pad else out[: col.n]


_COLUMNS_CACHE: dict[tuple, object] = {}


def decode_columns(cols: list[EncodedColumn], *, pad: bool = False) -> dict[str, jax.Array]:
    """Decode a whole container worth of columns in one jitted program —
    the mixed-column set of BASELINE configs[4]. XLA schedules the
    independent column decodes back-to-back on-chip (one dispatch, no host
    round-trips between columns). The combined program is cached on the
    tuple of column static keys, so repeated container decodes dispatch
    without retracing."""
    key = tuple(c.static_key() for c in cols)
    run = _COLUMNS_CACHE.get(key)
    if run is None:
        decoders = [get_decoder(c, narrow_store_dtype(c)) for c in cols]

        @jax.jit
        def run(streams_list):
            return [d(s) for d, s in zip(decoders, streams_list)]

        _COLUMNS_CACHE[key] = run
    streams = [device_streams(c) for c in cols]
    outs = run(streams)
    result = {}
    for c, u in zip(cols, outs):
        o = _to_logical(u, c.dtype)
        result[c.name] = o if pad else o[: c.n]
    return result


def _to_logical(u: jax.Array, dtype: str) -> jax.Array:
    dt = np_dtype(dtype)
    if u.dtype.itemsize == dt.itemsize:  # already at storage width
        return jax.lax.bitcast_convert_type(u, dt) if u.dtype != dt else u
    return jax.lax.convert_element_type(u, dt)  # narrow: wraps = truncation
