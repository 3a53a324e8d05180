"""RLE / RPE — device decoders (FORMAT.md §1.5–1.6; BASELINE configs[3]).

The irregular decoder of the family (libgiddy ``run_length_encoding.cuh``,
SURVEY.md call stack CS-4), in the reference's own form: every element
binary-searches its position in its group's sorted run-end table
(log2(r_pad) branchless probes), then gathers the run value. It runs on
the container's own per-GROUP tables (runs are split at GROUP boundaries
and padded to ``r_pad`` by the encoder, FORMAT §1.5), so the host does no
re-layout. rpe's run starts become ends by a one-run shift.

Measured on an H100 against per-tile select chains, per-tile searches and
scatter+cumsum (CHANGES.md, PR 1): re-tiled tables decode faster on the
device, but their host re-layout costs far more than they save per call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, next_power_of_2, num_groups


def expand_runs(ends, vals):
    """out[g, j] = vals[g, #{k : ends[g, k] <= j}]: (ng, r_pad) sorted
    exclusive run ends and run values -> (ng, GROUP). Every group's last
    end is the GROUP sentinel, so the rank stays < r_pad. The probes index
    the flattened tables (row offset + rank), which XLA gathers without
    materializing per-row batch indices; ``clip`` keeps any index from a
    corrupt table inside the arrays."""
    ng, r_pad = vals.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (ng, GROUP), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (ng, GROUP), 0) * jnp.int32(r_pad)
    flat_ends, flat_vals = ends.reshape(-1), vals.reshape(-1)
    r = jnp.zeros((ng, GROUP), jnp.int32)
    step = next_power_of_2(r_pad) // 2
    while step:
        e = jnp.take(flat_ends, row + r + jnp.int32(step - 1), mode="clip")
        r = r + jnp.where(e <= col, jnp.int32(step), jnp.int32(0))
        step //= 2
    return jnp.take(flat_vals, row + r, mode="clip")


def run_tables(run_values, bounds, *, positions: bool) -> dict:
    """(ng, r_pad) run tables -> the decoder's streams: exclusive run ends
    (rpe's starts shift left by one run, the last real run ending at the
    GROUP sentinel) and run values."""
    if positions:
        ng = bounds.shape[0]
        bounds = np.concatenate([bounds[:, 1:], np.full((ng, 1), GROUP, bounds.dtype)], axis=1)
    return {"ends": bounds, "vals": run_values}


def _prep(col: EncodedColumn, *, positions: bool) -> dict:
    if "ends" in col.streams:
        return col.streams  # already in device (dist/slice) form
    r_pad = col.params["r_pad"]
    ng = num_groups(col.n)
    key = "run_starts" if positions else "run_ends"
    return run_tables(
        col.streams["run_values"].reshape(ng, r_pad),
        col.streams[key].reshape(ng, r_pad),
        positions=positions,
    )


def build(col: EncodedColumn, out_store=None):
    ng = num_groups(col.n)
    out_dt = out_store or jnp.uint32

    def decode(streams):
        ends = streams["ends"].reshape(ng, -1).astype(jnp.int32)
        vals = streams["vals"].reshape(ng, -1)
        return expand_runs(ends, vals).astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("rle", build, lambda col: _prep(col, positions=False), narrow_store=True)
registry.register_device("rpe", build, lambda col: _prep(col, positions=True), narrow_store=True)
