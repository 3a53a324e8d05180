"""XOR-delta — device decoder (FORMAT.md §1.15; beyond-parity scheme).

Gorilla-style float compression: the decoder is the delta decoder with
the adds swapped for XORs — unpack, per-group prefix-XOR, XOR the anchor.
Same anchor machinery, same zero-cross-group-dependency story, so
sharding works unchanged.
"""

from __future__ import annotations

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import group_cumxor, unpack_lanes


def build(col: EncodedColumn):
    bits = col.params["bits"]
    ng = num_groups(col.n)

    def decode(streams):
        z = unpack_lanes(streams["packed"], bits)
        anchors = streams["anchors"].reshape(ng, 1)
        return (group_cumxor(z) ^ anchors).reshape(ng * GROUP)

    return decode


registry.register_device("xordelta", build)
