"""giddy-tpu: lossless lightweight columnar decompression on the GPU.

A from-scratch JAX framework with the capabilities of
github.com/eyalroz/libgiddy (CUDA; see SURVEY.md — the reference mount was
empty, SURVEY.md §0, so upstream citations are reconstructed paths and the
CPU codecs in :mod:`giddy_tpu.ref` are the bit-exactness oracle).

Layers (SURVEY.md §2): util (L0) → JAX runtime (L1) → kernels.lanes (L2) →
kernels.* (L3) → registry + api (L4) → dist (L6, multi-host; new scope).
"""

from .api import decode, decode_columns, decode_ref, encode, get_decoder
from .format import EncodedColumn, container_bytes, read_container, write_container
from .join import join_indices, join_tables
from .nulls import count_valid, decode_masked, null_count, valid_mask
from .registry import get, schemes
from .table import Table
from .topk import order_by, top_k
from .util import GROUP, LANES, SLOTS

__version__ = "0.1.0"

__all__ = [
    "EncodedColumn",
    "GROUP",
    "LANES",
    "SLOTS",
    "Table",
    "container_bytes",
    "count_valid",
    "decode",
    "decode_columns",
    "decode_masked",
    "decode_ref",
    "encode",
    "get",
    "get_decoder",
    "join_indices",
    "join_tables",
    "null_count",
    "order_by",
    "read_container",
    "top_k",
    "schemes",
    "valid_mask",
    "write_container",
]
