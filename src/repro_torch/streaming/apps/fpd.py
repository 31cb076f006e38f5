"""Frequent pattern detection (FPD) -- the paper's second application
(§V-A), the counterpart of ``repro/streaming/apps/fpd.py``.

Topology (paper Fig. 5): the window-enter / window-leave events -> pattern
generator -> detector (with a SELF-LOOP for cross-instance state-change
notifications) -> reporter.

Transactions are itemsets over ``n_items <= 32`` items packed into a
bitmask; pattern P is contained in transaction T iff ``P & T == P``.  A
**maximal frequent pattern** (MFP) occurs at least ``support_threshold``
times in the sliding window while no strict superset does.

On the device the masks are int64 (torch's ``uint32`` lacks ``&`` and
``==`` on CUDA; 32 items fit either way): :func:`support_counts` and
:func:`maximal_frequent` run there, and :class:`SlidingWindowState` keeps
its per-pattern counts, its MFP flags and the ``[P, P]`` strict-superset
matrix on the device (P = 5,488 patterns at 32 items, size <= 3), so one
event costs one device read: the new ``[P]`` MFP flags.  The host keeps
the window's masks (a deque), the numpy pattern list and the flags'
copy it compares against.

The detector's self-loop leaks: a notification spawns no further
notifications, so the Jackson stability condition holds.
"""

from __future__ import annotations

import functools
import itertools
import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ...device import resolve_device

__all__ = [
    "FPDConfig",
    "pack_itemset",
    "candidate_patterns",
    "support_counts",
    "maximal_frequent",
    "SlidingWindowState",
    "random_transaction",
    "build_fpd_operators",
    "build_fpd_graph",
]


@dataclass(frozen=True)
class FPDConfig:
    n_items: int = 16  # vocabulary (<= 32 for the 32-bit masks)
    max_pattern_size: int = 3  # candidate itemsets up to this many items
    window: int = 512  # sliding window size in transactions (paper: 50000)
    support_threshold: int = 32  # occurrence count for "frequent"
    items_per_txn_lo: int = 2
    items_per_txn_hi: int = 6


def pack_itemset(items: list[int] | tuple[int, ...]) -> int:
    mask = 0
    for it in items:
        mask |= 1 << it
    return mask


@functools.lru_cache(maxsize=8)
def _all_patterns(n_items: int, max_size: int) -> np.ndarray:
    """All candidate patterns (bitmasks) of size 1..max_size, sorted."""
    pats = []
    for size in range(1, max_size + 1):
        for combo in itertools.combinations(range(n_items), size):
            pats.append(pack_itemset(combo))
    return np.asarray(sorted(pats), dtype=np.uint32)


def candidate_patterns(transaction_mask: int, cfg: FPDConfig) -> np.ndarray:
    """Patterns generated from one transaction: all sub-itemsets up to
    max_pattern_size (the paper's pattern-generator bolt)."""
    items = [i for i in range(cfg.n_items) if transaction_mask >> i & 1]
    pats = []
    for size in range(1, min(cfg.max_pattern_size, len(items)) + 1):
        for combo in itertools.combinations(items, size):
            pats.append(pack_itemset(combo))
    return np.asarray(pats, dtype=np.uint32)


def _masks(x, device) -> torch.Tensor:
    """Bitmasks (numpy uint32, ints or a tensor) as int64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def support_counts(patterns: torch.Tensor, window_masks: torch.Tensor) -> torch.Tensor:
    """Occurrence count of each pattern in the window: int64 masks
    ``patterns [P]`` and ``window_masks [W]`` -> int32 ``[P]``."""
    contained = (window_masks[None, :] & patterns[:, None]) == patterns[:, None]
    return contained.sum(dim=1).to(torch.int32)


def _superset_matrix(patterns: torch.Tensor) -> torch.Tensor:
    """``is_superset[i, j]``: pattern j is a strict superset of pattern i."""
    sub = (patterns[None, :] & patterns[:, None]) == patterns[:, None]
    return sub & (patterns[None, :] != patterns[:, None])


def _mfp(superset: torch.Tensor, counts: torch.Tensor, threshold: int) -> torch.Tensor:
    frequent = counts >= threshold
    has_freq_superset = (superset & frequent[None, :]).any(dim=1)
    return frequent & ~has_freq_superset


def maximal_frequent(patterns: torch.Tensor, counts: torch.Tensor, threshold: int
                     ) -> torch.Tensor:
    """MFP mask: frequent and no frequent strict superset (paper's (a)+(b))."""
    return _mfp(_superset_matrix(patterns), counts, threshold)


@dataclass
class SlidingWindowState:
    """Detector state: the window's masks (host) + per-pattern counts and
    MFP flags (on ``device``, default: the CUDA device).  ``patterns`` is
    the numpy uint32 pattern list and ``mfp_np`` the host copy of the MFP
    flags as of the last event; :meth:`counts_host` reads the counts back."""

    cfg: FPDConfig
    device: torch.device | str | None = None
    patterns: np.ndarray = field(default=None)
    window: deque = field(default_factory=deque)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.patterns is None:
            self.patterns = _all_patterns(self.cfg.n_items, self.cfg.max_pattern_size)
        self.patterns_dev = _masks(self.patterns, self.device)
        self.counts = torch.zeros(len(self.patterns), dtype=torch.int64, device=self.device)
        self.mfp = torch.zeros(len(self.patterns), dtype=torch.bool, device=self.device)
        self.mfp_np = np.zeros(len(self.patterns), dtype=bool)  # host copy of ``mfp``
        # Constant for the pattern list: built once, not per event.
        self._superset = _superset_matrix(self.patterns_dev)

    def _delta(self, mask: int, sign: int) -> None:
        contained = (self.patterns_dev & mask) == self.patterns_dev
        self.counts.add_(contained.to(torch.int64), alpha=sign)

    def apply(self, mask: int, entering: bool) -> list[int]:
        """Apply a +/- event; returns the indices of the patterns whose MFP
        state changed (these become self-loop notifications)."""
        if entering:
            self.window.append(mask)
            self._delta(mask, +1)
            if len(self.window) > self.cfg.window:
                self._delta(self.window.popleft(), -1)
        elif self.window:
            try:
                self.window.remove(mask)
                self._delta(mask, -1)
            except ValueError:
                pass
        self.mfp = _mfp(self._superset, self.counts, self.cfg.support_threshold)
        new_np = self.mfp.cpu().numpy()  # the event's one device read ([P] flags)
        changed = np.nonzero(new_np != self.mfp_np)[0]
        self.mfp_np = new_np
        return changed.tolist()

    def counts_host(self) -> np.ndarray:
        return self.counts.cpu().numpy()

    def current_mfps(self) -> np.ndarray:
        return self.patterns[self.mfp_np]


def random_transaction(cfg: FPDConfig, rng: np.random.Generator) -> int:
    """Skewed item popularity (Zipf-ish) so real frequent patterns emerge."""
    n = rng.integers(cfg.items_per_txn_lo, cfg.items_per_txn_hi + 1)
    probs = 1.0 / np.arange(1, cfg.n_items + 1)
    probs /= probs.sum()
    items = rng.choice(cfg.n_items, size=min(n, cfg.n_items), replace=False, p=probs)
    return pack_itemset(items.tolist())


def build_fpd_operators(cfg: FPDConfig, *, device=None):
    """Operators for the StreamEngine: generate -> detect (self-loop) ->
    report, the detector's state on ``device`` (default: the CUDA device).

    Payloads: (mask, entering) -> ("detect", ...) -> notifications.
    Returns ``(ops, state, reports)``.
    """
    from ..engine import Operator

    state = SlidingWindowState(cfg, device=device)
    reports: list[tuple[int, bool]] = []
    state_lock = threading.Lock()

    def generate_fn(payload):
        mask, entering = payload
        # The generator bolt expands the candidates (cost ~ 2^|txn|); the
        # expansion is folded into the event for the detector.
        cands = candidate_patterns(mask, cfg)
        return [("detect", (mask, entering, cands))]

    def detect_fn(payload):
        if payload[0] == "notify":
            # Self-loop notification: cross-instance state sync.  Leaks
            # (no further emissions): Jackson stability.
            return []
        mask, entering, _cands = payload
        with state_lock:
            changed = state.apply(mask, entering)
            out = [("report", (int(i), bool(state.mfp_np[i]))) for i in changed]
        out += [("detect", ("notify", int(i))) for i in changed]
        return out

    def report_fn(payload):
        reports.append(payload)
        return []

    ops = [
        Operator("generate", generate_fn),
        Operator("detect", detect_fn),
        Operator("report", report_fn),
    ]
    return ops, state, reports


def build_fpd_graph(
    cfg: FPDConfig,
    *,
    rate: float = 16.0,
    loop_p: float = 0.3,
    mus: tuple[float, float, float] = (4.0, 3.0, 12.0),
    device=None,
):
    """The FPD application as an :class:`~repro_torch.api.graph.AppGraph`:
    generate -> detect -> report with the detector's leaking SELF-LOOP as a
    typed edge (``detect -> detect`` at multiplicity ``loop_p``, the mean
    rate of MFP state-change notifications per event).  The detector runs
    on ``device`` (default: the CUDA device).  Returns ``(graph, state,
    reports)``."""
    from ...api.graph import AppGraph, Edge, OpDef

    ops, state, reports = build_fpd_operators(cfg, device=device)
    graph = AppGraph(
        [OpDef(op.name, mu=mu, fn=op.fn) for op, mu in zip(ops, mus)],
        [
            Edge("generate", "detect"),
            Edge("detect", "detect", multiplicity=loop_p),
            Edge("detect", "report", multiplicity=1.0 - loop_p),
        ],
        {"generate": rate},
    )
    return graph, state, reports
