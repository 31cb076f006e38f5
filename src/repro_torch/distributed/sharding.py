"""The static ladder of compacted widths the sparse decide dispatches to
(``repro/distributed/sharding.py:bucket_ladder``)."""

from __future__ import annotations

__all__ = ["bucket_ladder"]


def bucket_ladder(b: int, *, fractions: tuple[int, ...] = (16, 4, 1)) -> tuple[int, ...]:
    """Ascending compacted widths for a batch extent ``b``: ``ceil(b / f)``
    for each fraction ``f``, and ``b`` itself (the dense rung, always
    present, so a tick on which every lane is repriced runs the dense
    decide).  The sparse decide gathers the repriced lanes into the
    smallest rung that holds them, so each tick runs at one of a few
    widths instead of at its exact active count."""
    if b < 1:
        raise ValueError(f"batch extent must be >= 1, got {b}")
    widths = {max(1, -(-b // f)) for f in fractions}
    widths.add(b)
    return tuple(sorted(w for w in widths if w <= b))
