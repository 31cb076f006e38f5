"""DRS resource negotiator (paper §IV + Appendix B-B), the live path's
copy of ``repro/core/negotiator.py``.

Works below the stream platform's resource manager: leases and releases
machines (fixed processor counts each) to reach the processor budget the
scheduler asks for, and tracks what is live.  Provider-side losses
(revocations) surface here first; the scheduler then re-runs Program (4)
with the smaller K_max.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Callable

__all__ = ["Machine", "ResourcePool", "Negotiator", "LeaseChange"]


@dataclass(frozen=True)
class Machine:
    machine_id: str
    processors: int  # executors (paper) / chips (pod)
    speed: float = 1.0  # heterogeneity: relative per-processor speed


@dataclass(frozen=True)
class LeaseChange:
    acquired: tuple[Machine, ...]
    released: tuple[Machine, ...]
    k_max_before: int
    k_max_after: int

    @property
    def delta(self) -> int:
        return self.k_max_after - self.k_max_before


class ResourcePool:
    """The provider side: a finite inventory of machines (cloud quota)."""

    def __init__(self, machines: list[Machine]):
        self._avail: dict[str, Machine] = {m.machine_id: m for m in machines}
        self._leased: dict[str, Machine] = {}
        self._lock = threading.Lock()

    @property
    def available(self) -> list[Machine]:
        with self._lock:
            return list(self._avail.values())

    @property
    def leased(self) -> list[Machine]:
        with self._lock:
            return list(self._leased.values())

    def lease(self, machine_id: str) -> Machine:
        with self._lock:
            m = self._avail.pop(machine_id)
            self._leased[machine_id] = m
            return m

    def release(self, machine_id: str) -> Machine:
        with self._lock:
            m = self._leased.pop(machine_id)
            self._avail[machine_id] = m
            return m

    def revoke(self, machine_id: str) -> Machine:
        """Provider-initiated loss (spot preemption / pod failure)."""
        with self._lock:
            return self._leased.pop(machine_id)


class Negotiator:
    """Leases machines to reach a requested processor budget.

    ``reserve`` processors are held back for system operators (the paper
    reserves 3 of its 25 executors for spouts + DRS itself).
    """

    def __init__(
        self,
        pool: ResourcePool,
        *,
        reserve: int = 0,
        on_change: Callable[[LeaseChange], None] | None = None,
    ):
        self.pool = pool
        self.reserve = reserve
        self.on_change = on_change
        self._lock = threading.Lock()

    @property
    def k_max(self) -> int:
        """Processors currently available to the application."""
        return max(0, sum(m.processors for m in self.pool.leased) - self.reserve)

    def ensure(self, k_target: int) -> LeaseChange:
        """Grow/shrink leases so that k_max >= k_target (grow) or release
        whole machines that are no longer needed (shrink).

        Machines are leased smallest-first when growing (minimise waste) and
        released largest-surplus-first when shrinking.  Never releases below
        k_target.
        """
        with self._lock:
            before = self.k_max
            acquired: list[Machine] = []
            released: list[Machine] = []
            need = k_target + self.reserve
            have = sum(m.processors for m in self.pool.leased)
            if have < need:
                for m in sorted(self.pool.available, key=lambda m: m.processors):
                    if have >= need:
                        break
                    acquired.append(self.pool.lease(m.machine_id))
                    have += m.processors
            elif have > need:
                for m in sorted(self.pool.leased, key=lambda m: -m.processors):
                    if have - m.processors >= need:
                        self.pool.release(m.machine_id)
                        released.append(m)
                        have -= m.processors
            change = LeaseChange(tuple(acquired), tuple(released), before, self.k_max)
            if self.on_change and (acquired or released):
                self.on_change(change)
            return change

    def machines_for(self, k: int, per_machine: int) -> int:
        """How many machines of a given size cover k processors."""
        return math.ceil(k / per_machine)

    def handle_revocation(self, machine_id: str) -> LeaseChange:
        """Provider preempted a machine: update books, notify scheduler."""
        with self._lock:
            before = self.k_max + self.reserve
            m = self.pool.revoke(machine_id)
            change = LeaseChange((), (m,), before - self.reserve, self.k_max)
            if self.on_change:
                self.on_change(change)
            return change
