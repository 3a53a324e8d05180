#!/usr/bin/env python
"""How XLA lowers a per-row uint32 prefix sum / prefix XOR on the device.

Times, on (rows, 32768) uint32 rows (one GROUP per row, the decoders'
scan shape): a plain copy of the same bytes, ``jnp.cumsum`` along the row,
``lax.associative_scan(bitwise_xor)`` along the row, and the two-level
forms (scan within 128-wide tiles, exclusive scan of the tile totals, add
the carry). Each number is the median of ``--iters`` calls after warm-up,
ended by ``block_until_ready``. Exits non-zero off the GPU.

Usage: python scripts/scan_forms.py [--rows 2048] [--iters 7]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

W = 32768
T = 128


def _two_level(x, op):
    rows = x.shape[0]
    y = x.reshape(rows, W // T, T)
    if op == "add":
        inner = jnp.cumsum(y, axis=2, dtype=jnp.uint32)
        tot = inner[:, :, -1]
        carry = jnp.cumsum(tot, axis=1, dtype=jnp.uint32) - tot
        return (inner + carry[:, :, None]).reshape(rows, W)
    inner = jax.lax.associative_scan(jnp.bitwise_xor, y, axis=2)
    tot = inner[:, :, -1]
    carry = jax.lax.associative_scan(jnp.bitwise_xor, tot, axis=1) ^ tot
    return (inner ^ carry[:, :, None]).reshape(rows, W)


FORMS = {
    "copy": lambda x: x + jnp.uint32(1),
    "cumsum": lambda x: jnp.cumsum(x, axis=1, dtype=jnp.uint32),
    "cumsum_two_level": lambda x: _two_level(x, "add"),
    "cumxor": lambda x: jax.lax.associative_scan(jnp.bitwise_xor, x, axis=1),
    "cumxor_two_level": lambda x: _two_level(x, "xor"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=7)
    a = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("no GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    x = jnp.asarray(np.random.default_rng(0).integers(0, 2**32, (a.rows, W), dtype=np.uint64).astype(np.uint32))
    ref = {}
    for name, f in FORMS.items():
        fn = jax.jit(f)
        out = jax.block_until_ready(fn(x))
        kind = "add" if "sum" in name else "xor"
        if name != "copy":
            ref.setdefault(kind, out)
            assert np.array_equal(np.asarray(out), np.asarray(ref[kind])), name
        for _ in range(2):
            jax.block_until_ready(fn(x))
        ts = []
        for _ in range(a.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x))
            ts.append(time.perf_counter() - t0)
        ms = statistics.median(ts) * 1e3
        print(json.dumps({"form": name, "rows": a.rows, "ms": ms,
                          "GBps_in_plus_out": 2 * x.nbytes / ms / 1e6}), flush=True)
    print(json.dumps({"card": card, "kind": jax.devices()[0].device_kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
