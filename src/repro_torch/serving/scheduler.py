"""Continuous-batching request scheduler with straggler-aware routing.

Admission control = cores x memory bin-packing in miniature: a request
needs one decode slot (the "cores") and cache pages (the "DRAM").  Without
the pool tier, requests whose KV doesn't fit in local HBM wait even while
slots idle — HBM stranding.  With the Pond tier, the control plane predicts
each request's hot footprint and admits it with local pages for the hot
part + pool pages for the cold tail.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.runtime.fault import StragglerTracker


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_len: int
    max_new_tokens: int
    customer: int = 0
    arrived_step: int = 0

    generated: int = 0

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens


class ContinuousBatcher:
    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.completed: list[Request] = []
        self.stragglers = StragglerTracker()
        self.wait_steps: dict[int, int] = {}

    def submit(self, req: Request):
        self.queue.append(req)

    def admit(self, can_admit) -> list[Request]:
        """can_admit(req) -> bool (cache capacity check). Admits FCFS."""
        admitted = []
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue[0]
            if not can_admit(req):
                break                       # FCFS: no head-of-line skip
            self.queue.popleft()
            self.active[req.req_id] = req
            admitted.append(req)
        return admitted

    def step_done(self, finished_ids):
        for rid in finished_ids:
            req = self.active.pop(rid, None)
            if req is not None:
                self.completed.append(req)

    @property
    def active_ids(self) -> list[int]:
        return sorted(self.active)

    def record_replica_time(self, replica: str, seconds: float):
        self.stragglers.record(replica, seconds)

    def healthy_replicas(self, replicas) -> list[str]:
        bad = set(self.stragglers.stragglers())
        good = [r for r in replicas if r not in bad]
        return good or list(replicas)
