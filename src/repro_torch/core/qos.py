"""QoS predicate of Pond's control plane (§4.3 B).

Only what the provisioning loop reads: the PDM-violation predicate that
charges mispredictions.  The monitor and mitigation manager come with the
``pond`` policy (ROADMAP M8).
"""
from __future__ import annotations


def exceeds_pdm(slowdown, pdm: float):
    """Canonical PDM-violation predicate: slowdown AT the margin counts.

    The paper's tail-latency predicate is inclusive (a VM whose slowdown
    reaches the performance degradation margin has exhausted it).  Works
    elementwise on arrays.
    """
    return slowdown >= pdm
