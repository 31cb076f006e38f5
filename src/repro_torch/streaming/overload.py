"""Overload policies for bounded operator queues.

``block`` holds arrivals until there is room (lossless; the batch
simulator encodes it as an unbounded queue), ``shed-newest`` drops the
arriving tuple and ``shed-oldest`` evicts the oldest queued one -- in the
fluid model both shed policies drop the same mass.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["OverloadPolicy", "OVERLOAD_POLICIES"]

OVERLOAD_POLICIES = ("block", "shed-newest", "shed-oldest")


@dataclass(frozen=True)
class OverloadPolicy:
    """What to do when a bounded operator queue is full.  ``block_poll`` is
    the live engine's wait granularity while blocked (it also bounds how
    long a worker can stall past an engine stop request)."""

    kind: str = "block"
    block_poll: float = 0.05

    def __post_init__(self) -> None:
        if self.kind not in OVERLOAD_POLICIES:
            raise ValueError(
                f"unknown overload policy {self.kind!r}; "
                f"expected one of {OVERLOAD_POLICIES}"
            )

    @classmethod
    def coerce(cls, value: "OverloadPolicy | str") -> "OverloadPolicy":
        """Accept either a policy object or its kind string."""
        if isinstance(value, OverloadPolicy):
            return value
        return cls(kind=value)

    @property
    def sheds(self) -> bool:
        return self.kind in ("shed-newest", "shed-oldest")
