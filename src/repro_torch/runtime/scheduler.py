"""Fault-tolerant work-queue scheduler for distributed ERA construction —
the port's own copy of ``repro.runtime.scheduler`` (standard library only).

The paper's parallel versions (§5) have a master distribute virtual trees
to workers "equally".  This scheduler keeps the paper's unit of work (the
virtual tree — independent, no merge phase) and adds the machinery around
it:

* **cost-aware ordering** — groups dispatched largest-frequency-first
  (longest-processing-time heuristic, online);
* **re-dispatch** — idle workers pull from the queue; a group assigned to
  a worker that misses its deadline is re-queued (straggler mitigation —
  duplicate completions are harmless because group construction is
  deterministic and idempotent);
* **node failure** — ``mark_failed(worker)`` re-queues all of that
  worker's in-flight groups;
* **per-group checkpointing** — completed groups are appended to a JSONL
  file, one record each, in the JAX package's format, so a checkpoint
  either package writes resumes in the other; recovery replays only the
  remainder.

The scheduler is host-side with a synchronous API (pull / complete
calls); the driver (:mod:`repro_torch.launch.era_run`) decides what a
worker is.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable


@dataclasses.dataclass
class Task:
    task_id: int
    cost: float               # predicted cost (group total frequency)
    payload: object = None    # e.g. a VirtualTree
    assigned_to: str | None = None
    assigned_at: float = 0.0
    attempts: int = 0
    done: bool = False


class WorkQueue:
    def __init__(self, *, deadline_factor: float = 3.0,
                 min_deadline_s: float = 5.0,
                 checkpoint_path: str | None = None):
        self._tasks: dict[int, Task] = {}
        self._pending: list[int] = []   # max-heap by cost (sorted desc)
        self._inflight: dict[int, Task] = {}
        self._deadline_factor = deadline_factor
        self._min_deadline_s = min_deadline_s
        self._ema_cost_rate: float | None = None  # seconds per unit cost
        self._ckpt = checkpoint_path
        self._completed_log: list[dict] = []
        if checkpoint_path and os.path.exists(checkpoint_path):
            with open(checkpoint_path) as f:
                self._completed_log = [json.loads(l) for l in f if l.strip()]

    # ---- setup -----------------------------------------------------------

    def add_tasks(self, costs: Iterable[float], payloads=None):
        payloads = list(payloads) if payloads is not None else None
        recovered = {r["task_id"] for r in self._completed_log}
        for i, c in enumerate(costs):
            t = Task(task_id=i, cost=float(c),
                     payload=payloads[i] if payloads else None)
            if i in recovered:
                t.done = True
            self._tasks[i] = t
        self._pending = sorted(
            (i for i, t in self._tasks.items() if not t.done),
            key=lambda i: -self._tasks[i].cost)

    # ---- worker API --------------------------------------------------------

    def pull(self, worker: str) -> Task | None:
        """Next task for ``worker`` (largest-cost-first); None if drained."""
        self._requeue_stragglers()
        if not self._pending:
            return None
        tid = self._pending.pop(0)
        t = self._tasks[tid]
        t.assigned_to = worker
        t.assigned_at = time.monotonic()
        t.attempts += 1
        self._inflight[tid] = t
        return t

    def complete(self, task_id: int, *, worker: str, elapsed_s: float | None = None,
                 result_meta: dict | None = None):
        t = self._tasks[task_id]
        if t.done:
            return  # duplicate completion from a re-dispatched straggler: fine
        t.done = True
        self._inflight.pop(task_id, None)
        if elapsed_s and t.cost > 0:
            rate = elapsed_s / t.cost
            self._ema_cost_rate = (rate if self._ema_cost_rate is None
                                   else 0.7 * self._ema_cost_rate + 0.3 * rate)
        rec = {"task_id": task_id, "worker": worker,
               "elapsed_s": elapsed_s, **(result_meta or {})}
        self._completed_log.append(rec)
        if self._ckpt:
            with open(self._ckpt, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # ---- failure / elasticity ---------------------------------------------

    def mark_failed(self, worker: str) -> list[int]:
        """Node loss: re-queue every in-flight task owned by ``worker``."""
        lost = [tid for tid, t in self._inflight.items() if t.assigned_to == worker]
        for tid in lost:
            self._requeue(tid)
        return lost

    def _requeue(self, tid: int):
        t = self._inflight.pop(tid, None)
        if t is None or t.done:
            return
        t.assigned_to = None
        # insert keeping cost-descending order
        lo, hi = 0, len(self._pending)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._tasks[self._pending[mid]].cost >= t.cost:
                lo = mid + 1
            else:
                hi = mid
        self._pending.insert(lo, tid)

    def _requeue_stragglers(self):
        """Re-dispatch tasks that exceeded their deadline (duplicate work is
        safe: deterministic + idempotent completion)."""
        if self._ema_cost_rate is None:
            return
        now = time.monotonic()
        for tid, t in list(self._inflight.items()):
            deadline = max(self._min_deadline_s,
                           self._deadline_factor * self._ema_cost_rate * t.cost)
            if now - t.assigned_at > deadline:
                self._requeue(tid)

    # ---- introspection ------------------------------------------------------

    @property
    def drained(self) -> bool:
        return all(t.done for t in self._tasks.values())

    @property
    def remaining(self) -> int:
        return sum(1 for t in self._tasks.values() if not t.done)

    def stats(self) -> dict:
        return {
            "total": len(self._tasks),
            "done": sum(1 for t in self._tasks.values() if t.done),
            "pending": len(self._pending),
            "inflight": len(self._inflight),
            "reattempts": sum(max(0, t.attempts - 1) for t in self._tasks.values()),
            "ema_cost_rate": self._ema_cost_rate,
        }
