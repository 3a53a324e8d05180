"""Scheme registry.

Analog of libgiddy's kernel factory/registry (upstream
``src/kernel_wrappers/`` + ``static_block`` registration — SURVEY.md §3.8).
Differences, by design:

- Registration is a decorator at import time (the analog of the reference's
  static-initializer ``static_block`` trick; linking a TU becomes importing
  a module).
- The registry key is the scheme name; type/width parameters that the
  reference bakes into C++ template instantiations are *runtime metadata*
  here — jit specialization plays the role of template instantiation, and
  the jit cache is the instantiated-kernel table.
- There is no launch configuration to resolve: every decoder is a plain
  XLA program over whole arrays, and XLA picks the GPU launch shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from .format import EncodedColumn


@dataclasses.dataclass
class Codec:
    scheme: str
    encode: Callable[..., EncodedColumn]
    decode_ref: Callable[[EncodedColumn], np.ndarray]
    # Device decoder: installed by giddy_tpu.kernels at import; takes the
    # column plus device arrays for its streams, returns a jax array of
    # n_pad elements (caller slices to n).
    decode_device: Callable[..., Any] | None = None
    # Optional host-side stream transform run before device upload: derived
    # per-group arrays (expanded frame refs, model coefficients) are cheap
    # to compute on the host and expensive as XLA prologues (on some
    # backends a trivial constant-gather prologue costs milliseconds of
    # dispatch), so they are materialized here and cross the jit boundary
    # as real arguments.
    prep_streams: Callable[[Any], dict] | None = None
    # Whether the device builder accepts ``out_store`` (a narrow unsigned
    # jnp dtype) and emits storage-width stores for int8/int16 columns —
    # full-column decode then writes 1/4 or 1/2 the HBM bytes instead of
    # padded uint32 + a separate XLA convert pass (the reference's
    # element-type template specialization, SURVEY.md §3.1, applied to the
    # output side). The uint32-payload contract of the fused scan layer
    # (query/aggregate/topk) is untouched: those callers never pass
    # out_store.
    narrow_store: bool = False


_REGISTRY: dict[str, Codec] = {}


def register(scheme: str, encode: Callable[..., EncodedColumn], decode_ref: Callable[[EncodedColumn], np.ndarray]) -> Codec:
    codec = Codec(scheme=scheme, encode=encode, decode_ref=decode_ref)
    _REGISTRY[scheme] = codec
    return codec


def register_device(scheme: str, decode_device: Callable[..., Any], prep_streams: Callable[[Any], dict] | None = None, narrow_store: bool = False) -> None:
    _REGISTRY[scheme].decode_device = decode_device
    _REGISTRY[scheme].prep_streams = prep_streams
    _REGISTRY[scheme].narrow_store = narrow_store


def get(scheme: str) -> Codec:
    try:
        return _REGISTRY[scheme]
    except KeyError:
        raise KeyError(
            f"scheme {scheme!r} not registered; known: {sorted(_REGISTRY)}"
        ) from None


def schemes() -> list[str]:
    return sorted(_REGISTRY)
