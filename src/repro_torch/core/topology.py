"""Pod topologies for multi-pool fleet simulation (Pond §3 + Octopus).

Pond's pool-size analysis (§3, Fig 3) shows 8-16 socket pods capture
most of the pooling benefit; Octopus (PAPERS.md) goes further and shows
*sparse, overlapping* pod topologies beat partitioned ones at equal
hardware cost, because a server that can reach more than one pod
smooths demand spikes across pods.  This module is the topology layer
for the fleet engines: a :class:`Topology` is a fixed VM->pods
incidence structure — per server, the ordered list of pods it can draw
CXL slices from — plus builders for the three families the fleet study
prices:

* :func:`partitioned` — disjoint pods of ``pod_size`` consecutive
  servers, fanout 1 (the classic Pond pool-group layout; with
  ``pod_size == n_servers`` this is :func:`single_pool`, the degenerate
  topology that must reproduce the single-pool engine bitwise).
* :func:`overlapping` — cyclic Octopus-style overlap: server ``s``
  reaches pods ``(s // pod_size + j) % n_pods`` for ``j < fanout``, so
  adjacent pods share servers and every pod keeps ``pod_size`` primary
  members (equal hardware: the pod count matches the partitioned
  layout, only the reach differs).
* :func:`sparse` — seeded random incidence: every server draws
  ``fanout`` distinct pods uniformly (a pod may end up with ZERO
  members, and with ``allow_orphans=True`` a server may reach no pod
  at all — both degenerate cases the differential suite covers).

**Incidence layout.**  ``inc`` is an ``(n_servers, fanout)`` int32
array; row ``s`` lists the pods server ``s`` can reach *in preference
order* (admission grants the whole pool demand from the FIRST listed
pod with room — one pod per VM, mirroring the one-EMC-group grant of
the single-pool engines), padded with ``-1`` for servers reaching
fewer than ``fanout`` pods.  The compiled sweeps consume this array
directly (padded, one row block per candidate lane); the scalar oracle
``cluster_sim.replay_multi_pool`` walks the same rows in the same
order, which is what makes the bit-exactness contract well defined.

Capacities are per pod, not per topology: :func:`split_pool` splits a
total pool budget into integral per-pod GBs (remainder spread over the
first pods) so fleet candidates at equal total hardware stay in the
integral-GB domain the bit-exact integer sweeps require.

The port's copy of the reference's ``core/topology.py`` (numpy only): the
same builders, seeds and draws, so both packages price the same incidence.
The compiled sweep here is kernel K4 (``kernels/pod_sweep``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: topology family names (``Topology.kind``)
KINDS = ("partitioned", "overlapping", "sparse", "single")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fixed server->pods incidence structure.

    ``inc[s]`` lists the pods server ``s`` may draw pool slices from,
    in preference order, ``-1``-padded.  Immutable by convention: the
    engines treat a Topology as compile-time data.
    """

    kind: str
    n_servers: int
    n_pods: int
    fanout: int                 # max pods any server reaches (inc width)
    inc: np.ndarray             # (n_servers, fanout) int32, -1 padded

    def __post_init__(self):
        validate_incidence(self.inc, self.n_pods, self.fanout)
        if self.inc.shape[0] != self.n_servers:
            raise ValueError(
                f"incidence rows {self.inc.shape[0]} != n_servers "
                f"{self.n_servers}")

    # ------------------------------------------------------------ queries --
    def pods_of(self, s: int) -> list[int]:
        """Reachable pods of server ``s``, in preference order."""
        row = self.inc[s]
        return [int(q) for q in row if q >= 0]

    def members(self, pod: int) -> list[int]:
        """Servers that can reach ``pod`` (may be empty — a pod with
        zero members is legal and simply never grants)."""
        return [int(s) for s in
                np.flatnonzero((self.inc == pod).any(axis=1))]

    def describe(self) -> str:
        return (f"{self.kind}(servers={self.n_servers}, "
                f"pods={self.n_pods}, fanout={self.fanout})")


def validate_incidence(inc: np.ndarray, n_pods: int,
                       fanout: int) -> None:
    """Raise ``ValueError`` unless ``inc`` is a valid incidence matrix:
    int array, width <= fanout, entries in ``[-1, n_pods)``, no
    duplicate pod within a row, and ``-1`` padding only at the tail of
    each row (preference order must be contiguous)."""
    inc = np.asarray(inc)
    if inc.ndim != 2 or not np.issubdtype(inc.dtype, np.integer):
        raise ValueError("incidence must be a 2-D integer array")
    if inc.shape[1] > max(fanout, 1):
        raise ValueError(
            f"incidence width {inc.shape[1]} exceeds fanout {fanout}")
    if inc.size and (inc.min() < -1 or inc.max() >= n_pods):
        raise ValueError(
            f"incidence entries must lie in [-1, {n_pods}); got range "
            f"[{inc.min()}, {inc.max()}]")
    for s in range(inc.shape[0]):
        row = inc[s]
        real = row[row >= 0]
        if len(np.unique(real)) != len(real):
            raise ValueError(f"server {s} lists a pod twice: {row}")
        # -1 padding must be a suffix, or "first pod with room" would
        # skip over holes differently in the oracle and the kernel
        seen_pad = False
        for q in row:
            if q < 0:
                seen_pad = True
            elif seen_pad:
                raise ValueError(
                    f"server {s} has interior -1 padding: {row}")


# ---------------------------------------------------------------- builders --
def partitioned(n_servers: int, pod_size: int) -> Topology:
    """Disjoint pods of ``pod_size`` consecutive servers (fanout 1).

    The last pod may be ragged.  ``partitioned(n, n)`` is the 1-pod
    degenerate (see :func:`single_pool`).
    """
    if pod_size < 1:
        raise ValueError("pod_size must be >= 1")
    n_pods = -(-n_servers // pod_size)
    inc = (np.arange(n_servers, dtype=np.int32)
           // pod_size)[:, None].astype(np.int32)
    return Topology("partitioned", n_servers, n_pods, 1, inc)


def single_pool(n_servers: int) -> Topology:
    """The 1-pod degenerate: every server reaches pod 0.  Must price
    bitwise-identically to the single-pool engines at equal capacity
    (asserted in ``tests/test_topology_engine.py``)."""
    t = partitioned(n_servers, n_servers)
    return Topology("single", n_servers, 1, 1, t.inc)


def overlapping(n_servers: int, pod_size: int, fanout: int) -> Topology:
    """Cyclic Octopus-style overlap at the partitioned pod count.

    Server ``s`` reaches pods ``(s // pod_size + j) % n_pods`` for
    ``j in [0, fanout)`` — its home pod first, then the next pods
    around the ring — so every pod keeps ``pod_size`` primary members
    and the hardware cost matches :func:`partitioned` exactly; only
    the reachability differs.  ``fanout`` clips to ``n_pods``.
    """
    if pod_size < 1 or fanout < 1:
        raise ValueError("pod_size and fanout must be >= 1")
    n_pods = -(-n_servers // pod_size)
    fanout = min(fanout, n_pods)
    home = np.arange(n_servers, dtype=np.int64) // pod_size
    inc = ((home[:, None] + np.arange(fanout)[None, :]) % n_pods)
    return Topology("overlapping", n_servers, n_pods, fanout,
                    inc.astype(np.int32))


def sparse(n_servers: int, n_pods: int, fanout: int, seed: int = 0,
           allow_orphans: bool = False) -> Topology:
    """Seeded random sparse incidence: each server draws ``fanout``
    distinct pods uniformly (row order = preference order).

    With ``allow_orphans=True`` roughly 1 in 4 servers reaches NO pod
    (an all ``-1`` row) — the "VM reachable by no pod" degenerate:
    pool-bearing decisions on those servers can only take the
    all-local fallback.  A pod with zero members can occur at any seed.
    """
    if n_pods < 1 or fanout < 1:
        raise ValueError("n_pods and fanout must be >= 1")
    fanout = min(fanout, n_pods)
    rng = np.random.default_rng(seed)
    inc = np.full((n_servers, fanout), -1, np.int32)
    for s in range(n_servers):
        if allow_orphans and rng.random() < 0.25:
            continue
        inc[s] = rng.choice(n_pods, size=fanout, replace=False)
    return Topology("sparse", n_servers, n_pods, fanout, inc)


# -------------------------------------------------------------- capacities --
def split_pool(total_pool_gb: float, n_pods: int) -> np.ndarray:
    """Split a total pool budget into integral per-pod GBs.

    Floors the total, gives every pod ``total // n_pods`` and spreads
    the remainder one GB at a time over the first pods — so equal
    total hardware compares across topologies while every per-pod
    capacity stays an integral GB (the bit-exact integer sweeps'
    domain).
    """
    if n_pods < 1:
        raise ValueError("n_pods must be >= 1")
    total = int(np.floor(total_pool_gb))
    if total < 0:
        raise ValueError("total_pool_gb must be >= 0")
    base, rem = divmod(total, n_pods)
    caps = np.full(n_pods, base, np.int64)
    caps[:rem] += 1
    return caps.astype(float)


def pod_caps_matrix(pod_gb, topologies) -> np.ndarray:
    """Normalize per-candidate pod capacities to a dense ``(C, P_max)``
    float array over a list of per-lane topologies.

    ``pod_gb`` may be a scalar (every pod of every lane), a 1-D
    ``(C,)`` array (per-lane uniform pod capacity) or a sequence of C
    per-pod arrays (each of length ``topologies[i].n_pods``).  Columns
    past a lane's pod count fill with 0 and are inert: no incidence
    row ever points at them.
    """
    c = len(topologies)
    p_max = max((t.n_pods for t in topologies), default=1)
    out = np.zeros((c, p_max))
    if np.isscalar(pod_gb) or getattr(pod_gb, "ndim", None) == 0:
        for i, t in enumerate(topologies):
            out[i, :t.n_pods] = float(pod_gb)
        return out
    if isinstance(pod_gb, np.ndarray) and pod_gb.ndim == 1 \
            and len(pod_gb) == c:
        for i, t in enumerate(topologies):
            out[i, :t.n_pods] = pod_gb[i]
        return out
    if len(pod_gb) != c:
        raise ValueError(
            f"pod_gb rows {len(pod_gb)} != {c} candidate lanes")
    for i, (t, row) in enumerate(zip(topologies, pod_gb)):
        row = np.atleast_1d(np.asarray(row, float))
        if len(row) == 1:
            out[i, :t.n_pods] = row[0]
        elif len(row) == t.n_pods:
            out[i, :t.n_pods] = row
        else:
            raise ValueError(
                f"lane {i}: {len(row)} pod capacities for "
                f"{t.n_pods} pods")
    return out
