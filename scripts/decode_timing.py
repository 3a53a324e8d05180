#!/usr/bin/env python
"""Warm decode time of every core scheme on the default device.

For each ``datagen.CORE_SCHEMES`` column at ``2**log2n`` elements: encode on
the host, upload the streams once, then time the jitted device decoder
(median of ``--iters`` calls after two warm-up calls, each ended by
``block_until_ready``; and the median over ``--iters`` batches of 10
back-to-back calls ended by one ``block_until_ready``, per call, which
hides the dispatch latency) and, separately, the whole ``gt.decode`` call
(host prep + upload + decode). Prints one JSON object per scheme and a
final summary line; exits non-zero off the GPU.

Usage (from the root of the tree to measure):
  python scripts/decode_timing.py [--log2n 24] [--iters 7] [--schemes a,b]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import jax  # noqa: E402
import numpy as np  # noqa: E402


def median_ms(run, iters: int, batch: int = 1) -> float:
    """Median wall time per call (ms) over ``iters`` timed batches of
    ``batch`` back-to-back calls, each batch ended by block_until_ready,
    after two warm-up calls."""
    for _ in range(2):
        jax.block_until_ready(run())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(batch):
            out = run()
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / batch)
    return statistics.median(times) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=24)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--schemes", default="")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: default device is {dev.platform}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)

    import giddy_tpu as gt
    from giddy_tpu.api import device_streams, narrow_store_dtype
    from giddy_tpu.datagen import CORE_SCHEMES, gen_column

    schemes = a.schemes.split(",") if a.schemes else CORE_SCHEMES
    n = 1 << a.log2n
    rows = []
    for scheme in schemes:
        rng = np.random.default_rng(a.seed)
        v = gen_column(scheme, n, rng)
        col = gt.encode(v, scheme, name=scheme)
        fn = gt.get_decoder(col, narrow_store_dtype(col))
        streams = device_streams(col)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(streams))
        first_s = time.perf_counter() - t0
        got = np.asarray(gt.decode(col))
        exact = bool(np.array_equal(got.view(np.uint8), gt.decode_ref(col).view(np.uint8)))
        dec_ms = median_ms(lambda: fn(streams), a.iters)
        batch_ms = median_ms(lambda: fn(streams), a.iters, batch=10)
        api_ms = median_ms(lambda: gt.decode(col), a.iters)
        row = {
            "scheme": scheme, "n": n, "exact": exact,
            "decode_ms": dec_ms, "decode_batched_ms": batch_ms, "gt_decode_ms": api_ms,
            "first_call_s": first_s,
            "decoded_GBps": col.nbytes_decoded / batch_ms / 1e6,
            "out_dtype": str(out.dtype),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "kind": dev.device_kind, "log2n": a.log2n,
                      "iters": a.iters, "all_exact": all(r["exact"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
