"""64-bit (wide) column support — plane-split wrapper (scheme ``wide``).

The CUDA reference's kernels are templated over element widths up to 64
bits (SURVEY.md §3.1 "parameterized on IndexSize and element types"). The
device compute path is 32-bit (JAX runs without 64-bit mode), so a wide
column splits into **lo/hi 32-bit planes at encode time**, each plane
encoded independently with any base scheme — per-plane decode is exact, so
``v = lo | hi << 32`` reconstructs losslessly, and the hi plane of
real-world 64-bit data (timestamps, keys) is near-constant and compresses
to almost nothing. Plane decode runs on-device (the jitted base decoders);
the 64-bit recombine happens at the host boundary.
"""

from __future__ import annotations

import numpy as np

from . import registry
from .format import EncodedColumn


def _split(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    u = values.view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def _sub(col: EncodedColumn, plane: str) -> EncodedColumn:
    # memoized on the parent: repeated scans must hand the SAME object to
    # identity-keyed placement caches (dist_query._ARGS_CACHE) instead of
    # re-uploading the plane streams every call
    attr = f"_sub_{plane}"
    cached = getattr(col, attr, None)
    if cached is not None:
        return cached
    p = col.params[f"{plane}_params"]
    sub = EncodedColumn(
        name=f"{col.name}.{plane}",
        scheme=col.params[f"{plane}_scheme"],
        dtype="uint32",
        n=col.n,
        params=p,
        streams={k[len(plane) + 1 :]: v for k, v in col.streams.items() if k.startswith(plane + "_")},
    )
    setattr(col, attr, sub)
    return sub


def encode(
    values: np.ndarray,
    *,
    base_scheme: str = "nbit",
    hi_scheme: str | None = None,
    name: str = "col",
    **base_opts,
) -> EncodedColumn:
    values = np.asarray(values)
    if values.dtype.itemsize != 8:
        raise ValueError(f"wide encode expects a 64-bit column, got {values.dtype}")
    lo, hi = _split(values)
    lo_col = registry.get(base_scheme).encode(lo, name="lo", **base_opts)
    hi_col = registry.get(hi_scheme or base_scheme).encode(hi, name="hi")
    streams = {f"lo_{k}": v for k, v in lo_col.streams.items()}
    streams.update({f"hi_{k}": v for k, v in hi_col.streams.items()})
    return EncodedColumn(
        name=name,
        scheme="wide",
        dtype=str(values.dtype),
        n=values.shape[0],
        params={
            "lo_scheme": lo_col.scheme,
            "lo_params": lo_col.params,
            "hi_scheme": hi_col.scheme,
            "hi_params": hi_col.params,
        },
        streams=streams,
    )


def _combine(lo: np.ndarray, hi: np.ndarray, dtype: str) -> np.ndarray:
    u = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return u.view(np.dtype(dtype))


def decode_ref(col: EncodedColumn) -> np.ndarray:
    lo_col, hi_col = _sub(col, "lo"), _sub(col, "hi")
    lo = registry.get(lo_col.scheme).decode_ref(lo_col).view(np.uint32)
    hi = registry.get(hi_col.scheme).decode_ref(hi_col).view(np.uint32)
    return _combine(lo, hi, col.dtype)


def decode_device(col: EncodedColumn, *, pad: bool = False) -> np.ndarray:
    """Device decode of both planes (jitted XLA), host recombine.
    Returns a NumPy array (int64 lives outside the device hot path);
    pad=True keeps the whole-GROUP-aligned n_pad length."""
    from .api import device_streams, get_decoder

    lo_col, hi_col = _sub(col, "lo"), _sub(col, "hi")
    lo = np.asarray(get_decoder(lo_col)(device_streams(lo_col)))
    hi = np.asarray(get_decoder(hi_col)(device_streams(hi_col)))
    if not pad:
        lo, hi = lo[: col.n], hi[: col.n]
    return _combine(lo, hi, col.dtype)


registry.register("wide", encode, decode_ref)
