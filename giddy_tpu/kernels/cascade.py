"""Cascade — device decoder (FORMAT.md §1.14).

Decode = the inner scheme's registered decoder on the ``c_``-prefixed code
streams, then the dictionary take (kernels/dict_.py) — XLA may fuse the
gather into the inner decode. The inner builder is metadata-only, so any
registered inner scheme composes without new decoder code — the device
analog of the reference composing schemes in the caller (SURVEY.md §3.2
compressed-indices patching is the same pattern).
"""

from __future__ import annotations

from .. import registry
from ..format import EncodedColumn
from ..ref.cascade import codes_column
from .dict_ import take_values


def build(col: EncodedColumn, out_store=None):
    d = col.params["dict_size"]
    inner = codes_column(col, streams={})
    inner_decode = registry.get(inner.scheme).decode_device(inner)

    def decode(streams):
        c_streams = {k[2:]: v for k, v in streams.items() if k.startswith("c_")}
        codes = inner_decode(c_streams)
        if d == 0:  # empty column: nothing to gather (pad codes pass through)
            return codes
        return take_values(streams["values"], codes, out_store)

    return decode


def prep(col: EncodedColumn) -> dict:
    inner = codes_column(col)
    p = registry.get(inner.scheme).prep_streams
    c_streams = p(inner) if p is not None else inner.streams
    return {"values": col.streams["values"], **{f"c_{k}": v for k, v in c_streams.items()}}


registry.register_device("cascade", build, prep, narrow_store=True)
