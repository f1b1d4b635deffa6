"""The sharding context threaded through the model's entry points.

The port runs on one card, so only the single-device context exists:
``mesh`` must stay ``None`` and ``constrain`` is the identity.  Rules,
``partition_tree`` and meshes arrive with the multi-device slice
(ROADMAP.md, M14).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threaded through the model's entry points; single device only."""
    attn_impl: str = "blocked"             # "blocked" | "dot" | "flash"
    remat: bool = False                    # recompute each layer in backward
    moe_decode_cf: float = 8.0             # looser capacity for tiny decode T
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md, M14): the port runs "
                "on one card")

    def constrain(self, x, spec=None):
        """Identity: on one device there is nothing to constrain."""
        return x
