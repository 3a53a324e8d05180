"""Structural SoL evidence (SURVEY.md §8.3.5): jax's memory analysis of
every registered decoder bounds its HBM temporaries. The caps are the
plain XLA program's temps as XLA:CPU compiles them (multiples of the output
bytes, measured at this n), plus half an output: reintroducing a dense HBM
intermediate (e.g. a scatter+cumsum RLE expansion, several outputs' worth)
fails the test.
"""

from __future__ import annotations

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.datagen import gen_column
from giddy_tpu.roofline import traffic_audit
from giddy_tpu.util import GROUP

# Every registered single-column scheme with a device decoder.
from giddy_tpu.datagen import CORE_SCHEMES as SCHEMES  # single source of truth

# temp / out measured on XLA:CPU at n = 8 * GROUP: raw/rle/rpe 0, most
# schemes 1.0, delta/xordelta/dict 2.0, bitmap 5.0, dzbv 6.8
TEMP_CAP = {"raw": 0.5, "rle": 0.5, "rpe": 0.5, "delta": 2.5, "xordelta": 2.5,
            "dict": 2.5, "bitmap": 5.5, "dzbv": 7.5}
TEMP_CAP_DEFAULT = 1.5


@pytest.mark.parametrize("scheme", SCHEMES)
def test_traffic_single_pass(scheme):
    rng = np.random.default_rng(11)
    n = 8 * GROUP  # multi-group plan, no ragged tail
    col = gt.encode(gen_column(scheme, n, rng), scheme, name=f"audit_{scheme}")
    a = traffic_audit(col)
    cap = TEMP_CAP.get(scheme, TEMP_CAP_DEFAULT)
    assert a["temp_bytes"] <= cap * a["out_bytes"], (
        f"{scheme}: temp {a['temp_bytes']} exceeds the {cap}x-out allowance "
        f"({a['out_bytes']} out bytes) — an extra decode pass over HBM crept in"
    )


def test_traffic_audit_reports_known_multipass():
    """The audit must actually *see* extra traffic: dzbv's two-pass decode
    (rank scan, then a gather per plane) is multi-pass by design, and its
    ratio must reflect that — guarding against the audit silently
    measuring the wrong program."""
    rng = np.random.default_rng(3)
    v = np.sort(gen_column("dzbv", 6 * GROUP, rng).view(np.uint32)).view(np.int32)
    col = gt.encode(v, "dzbv", name="audit_skew")
    a = traffic_audit(col)
    assert a["temp_bytes"] > 0
    assert a["sol_ratio"] > 1.15
