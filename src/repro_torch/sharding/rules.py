"""The sharding context threaded through the model's entry points.

The port runs on one card, so only the single-device context exists:
``mesh`` must stay ``None`` and ``constrain`` is the identity.  Without a
mesh every MoE layer takes the dense path, as the reference's
``apply_moe`` does without one, so ``moe_impl`` takes only "auto" and
"dense"; the sharded paths and their capacity settings come with the
mesh.  Rules,
``partition_tree`` and meshes arrive with the multi-device slice
(ROADMAP.md, M14b).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threaded through the model's entry points; single device only."""
    moe_impl: str = "auto"                 # "auto" | "dense"
    attn_impl: str = "blocked"             # "blocked" | "dot" | "flash"
    remat: bool = False                    # recompute each layer in backward
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md, M14b): the port runs "
                "on one card")
        if self.moe_impl not in ("auto", "dense"):
            raise ValueError(
                f"moe_impl {self.moe_impl!r}: the sharded MoE paths need a "
                "mesh (ROADMAP.md, M14b); one of 'auto', 'dense'")

    def constrain(self, x, spec=None):
        """Identity: on one device there is nothing to constrain."""
        return x
