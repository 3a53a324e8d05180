"""Roofline / speed-of-light accounting (SURVEY.md §6 tracing row,
§8.3.5: agree the denominator early and bake it into the harness).

SoL model: decode must read the compressed streams once and write the
decoded column once; the floor time is ``bytes_touched / HBM_BW``. The
BASELINE target is decoded-GB/s >= 80% of ``decoded_bytes / floor_time``.

The structural companion, :func:`traffic_audit`, reads the bytes side
from the compiled program's memory analysis: a single-pass decoder shows
``temp == 0``.
"""

from __future__ import annotations

import dataclasses

from .format import EncodedColumn

# Published HBM bandwidth (bytes/s) per ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB part.
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def chip_bw(device_kind: str | None = None) -> float:
    """Peak HBM bytes/s of ``device_kind`` (default: the first device's).
    A kind missing from :data:`HBM_BW` is an error, never a default."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return HBM_BW[device_kind]
    except KeyError:
        raise KeyError(
            f"no published HBM bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(HBM_BW)}"
        ) from None


@dataclasses.dataclass
class Roofline:
    decoded_bytes: int
    compressed_bytes: int
    hbm_bw: float

    @property
    def bytes_touched(self) -> int:
        return self.decoded_bytes + self.compressed_bytes

    @property
    def floor_time_s(self) -> float:
        return self.bytes_touched / self.hbm_bw

    @property
    def sol_decode_gbps(self) -> float:
        """Decoded GB/s at speed of light."""
        return self.decoded_bytes / 1e9 / self.floor_time_s

    def sol_fraction(self, measured_time_s: float) -> float:
        """Measured fraction of speed-of-light (the BASELINE >=0.8 target)."""
        return self.floor_time_s / max(measured_time_s, 1e-12)


def column_roofline(col: EncodedColumn, device_kind: str | None = None) -> Roofline:
    return Roofline(
        decoded_bytes=col.nbytes_decoded,
        compressed_bytes=col.nbytes_compressed,
        hbm_bw=chip_bw(device_kind),
    )


def traffic_audit(col: EncodedColumn) -> dict:
    """Structural SoL evidence: bytes-touched of the *compiled* decoder.

    The compiled program's memory analysis is exact: a single-pass decoder
    shows ``temp == 0`` — every byte of traffic is either a staged input
    stream or the decoded output. ``traffic = args + out + 2*temp`` (a temp
    buffer is written once and read once); ``ratio = traffic / (args + out)``
    is 1.0 for a perfect single-pass program (a ratio r caps physical SoL
    at 1/r). It describes the program compiled for the current backend.
    """
    from . import api

    # audit the decoder full-column decode actually dispatches — incl. the
    # storage-width store for narrow columns (api.narrow_store_dtype)
    fn = api.get_decoder(col, api.narrow_store_dtype(col))
    streams = api.device_streams(col)
    ma = fn.lower(streams).compile().memory_analysis()
    args = int(ma.argument_size_in_bytes)
    out = int(ma.output_size_in_bytes)
    temp = int(ma.temp_size_in_bytes)
    traffic = args + out + 2 * temp
    return {
        "scheme": col.scheme,
        "n": col.n,
        "args_bytes": args,
        "out_bytes": out,
        "temp_bytes": temp,
        "traffic_bytes": traffic,
        "ideal_bytes": args + out,
        "ratio": traffic / max(args + out, 1),
        # sol_ratio additionally charges host-prep stream inflation: the
        # denominator is what a perfect decoder of THIS container must touch
        # (compressed streams in + the padded output tile write, which the
        # GROUP format mandates). >1 means extra HBM traffic somewhere —
        # temps, prep padding, or dead stream uploads; a ratio r caps
        # physical SoL at 1/r, so the >=80% BASELINE target needs r <= 1.25.
        "sol_ratio": traffic / max(col.nbytes_compressed + out, 1),
        "compressed_bytes": col.nbytes_compressed,
        "decoded_bytes": col.nbytes_decoded,
    }
