"""Device decoders (plain jitted XLA programs) — the hot path (SURVEY.md §3.1, call stack CS-2).

Importing this package installs a device decoder for every registered
scheme (the analog of linking libgiddy's kernel-wrapper TUs: import =
``static_block`` registration, SURVEY.md §3.8/CS-1).
"""

from .. import ref as _ref  # noqa: F401  (CPU codecs must register first)
from . import (  # noqa: F401  (import = registration)
    alp,
    bitmap,
    cascade,
    delta,
    delta2,
    dict_,
    dzbv,
    for_,
    model,
    nbit,
    patch,
    raw,
    rle,
    xordelta,
)
