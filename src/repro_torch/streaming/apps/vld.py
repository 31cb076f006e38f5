"""Video logo detection (VLD) -- the paper's first application (§V-A).

Topology (paper Fig. 4): spout -> feature extractor -> feature matcher ->
matching aggregator, the counterpart of ``repro/streaming/apps/vld.py``:

* **spout**: :func:`make_frame` -- synthetic grayscale frames (numpy) with
  a logo's descriptor patches blended in for a share of them;
* **extractor**: :func:`extract_features` -- difference-of-Gaussians
  response, 3x3 local maxima, the strongest ``max_keypoints`` of them and
  one unit-norm ``patch x patch`` descriptor each (plain PyTorch: the JAX
  extractor is jnp, with no Pallas kernel);
* **matcher**: :func:`match_features` -- per library descriptor, the frame
  descriptors within ``match_threshold``: the ``l2_match`` kernel
  (``kernels/l2_match``, CUDA on the card);
* **aggregator**: :func:`aggregate_matches` -- per-logo detections.

Every function takes its tensors on the device they should run on; the
operator builders take a ``device`` that defaults to the CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.l2_match import ops as l2_ops

__all__ = ["VLDConfig", "make_frame", "keypoints", "extract_features", "match_features",
           "aggregate_matches", "build_vld_operators", "build_vld_graph",
           "logo_library"]


@dataclass(frozen=True)
class VLDConfig:
    height: int = 64
    width: int = 64
    patch: int = 8  # descriptor patch size
    max_keypoints: int = 32  # fixed upper bound (padded, static shapes)
    n_logos: int = 16  # paper: 16 query logos
    descriptors_per_logo: int = 8
    match_threshold: float = 0.8  # L2 threshold on unit descriptors
    detect_threshold: int = 2  # matched features needed to declare a logo
    dog_sigma1: float = 1.0
    dog_sigma2: float = 2.0
    response_floor: float = 0.08  # only content blobs pass


def _gaussian_taps(sigma: float) -> list[float]:
    """Normalised 1-D Gaussian taps of radius ``int(3 sigma + 0.5)``,
    computed once in float32 on the host (so every device blurs with the
    same weights)."""
    radius = int(3 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).tolist()


def _blur(img: torch.Tensor, taps: list[float]) -> torch.Tensor:
    """Separable 'same' Gaussian: rows, then columns, zero padded.  The taps
    are summed one elementwise multiply-add at a time in a fixed order
    (no convolution library, whose float32 may be TF32 on the card)."""
    r = len(taps) // 2
    h, w = img.shape
    pad = torch.nn.functional.pad(img, (r, r))
    out = torch.zeros_like(img)
    for t, kt in enumerate(taps):
        out = out + pad[:, t:t + w] * kt
    pad = torch.nn.functional.pad(out, (0, 0, r, r))
    out = torch.zeros_like(img)
    for t, kt in enumerate(taps):
        out = out + pad[t:t + h, :] * kt
    return out


def keypoints(frame: torch.Tensor, cfg: VLDConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``max_keypoints`` strongest DoG local maxima of one ``[H, W]``
    float32 frame: ``(flat index [max_keypoints] int64, valid
    [max_keypoints] bool)``, by descending response.  Ties (and the padded
    ``-inf`` entries) go to the larger flat index first, as the reference's
    reversed stable ascending sort orders them (``torch.topk`` would not)."""
    h, w = frame.shape
    dog = (_blur(frame, _gaussian_taps(cfg.dog_sigma1))
           - _blur(frame, _gaussian_taps(cfg.dog_sigma2))).abs()
    # Local maxima on a 3x3 neighbourhood.
    pad = torch.nn.functional.pad(dog, (1, 1, 1, 1), value=float("inf"))
    neigh = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            neigh = s if neigh is None else torch.maximum(neigh, s)
    is_max = (dog >= neigh) & (dog > cfg.response_floor)
    # Exclude borders where descriptor patches would clip.
    half = cfg.patch // 2
    border = torch.zeros_like(is_max)
    border[half:-half, half:-half] = True
    score = torch.where(is_max & border, dog, torch.full_like(dog, float("-inf"))).reshape(-1)
    flat_idx = torch.argsort(score, stable=True).flip(0)[: cfg.max_keypoints]
    return flat_idx, score[flat_idx] > float("-inf")


def extract_features(frame: torch.Tensor, cfg: VLDConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """DoG keypoints + patch descriptors of one ``[H, W]`` float32 frame.

    Returns ``(descriptors [max_keypoints, patch*patch], valid
    [max_keypoints])`` on the frame's device, in :func:`keypoints` order.
    Each descriptor is the zero-mean, unit-norm patch around its keypoint;
    padded entries slice their patch from the clamped corner, as
    ``jax.lax.dynamic_slice`` does.
    """
    frame = frame.to(torch.float32)
    h, w = frame.shape
    flat_idx, valid = keypoints(frame, cfg)
    half = cfg.patch // 2
    y0 = torch.clamp(flat_idx // w - half, 0, h - cfg.patch)
    x0 = torch.clamp(flat_idx % w - half, 0, w - cfg.patch)
    offs = torch.arange(cfg.patch, device=frame.device)
    rows = (y0[:, None] + offs[None, :])[:, :, None]
    cols = (x0[:, None] + offs[None, :])[:, None, :]
    v = frame[rows, cols].reshape(flat_idx.shape[0], -1)
    v = v - v.mean(dim=1, keepdim=True)
    desc = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-6)
    return desc, valid


def logo_library(cfg: VLDConfig, seed: int = 7) -> np.ndarray:
    """Pre-generated logo descriptor library [n_logos * dpl, D] (unit
    norm, float32 numpy): the reference's numbers from the same seed."""
    rng = np.random.default_rng(seed)
    d = cfg.patch * cfg.patch
    lib = rng.normal(size=(cfg.n_logos * cfg.descriptors_per_logo, d)).astype(np.float32)
    lib -= lib.mean(axis=1, keepdims=True)
    lib /= np.linalg.norm(lib, axis=1, keepdims=True) + 1e-6
    return lib


def make_frame(
    cfg: VLDConfig, rng: np.random.Generator, library: np.ndarray, with_logo: bool
) -> np.ndarray:
    """Synthetic frame; optionally blends logo descriptor patches in (the
    reference's generator: the same ``rng`` gives the same frame)."""
    frame = rng.normal(scale=0.08, size=(cfg.height, cfg.width)).astype(np.float32)
    # Sprinkle generic blobs (keypoint fodder whose count varies per frame).
    n_blobs = rng.integers(2, 14)
    for _ in range(n_blobs):
        y = rng.integers(cfg.patch, cfg.height - cfg.patch)
        x = rng.integers(cfg.patch, cfg.width - cfg.patch)
        frame[y - 1 : y + 2, x - 1 : x + 2] += rng.uniform(0.5, 1.0)
    if with_logo:
        logo_id = rng.integers(cfg.n_logos)
        for j in range(cfg.descriptors_per_logo):
            d = np.asarray(library[logo_id * cfg.descriptors_per_logo + j])
            patch = d.reshape(cfg.patch, cfg.patch)
            y = rng.integers(cfg.patch, cfg.height - 2 * cfg.patch)
            x = rng.integers(cfg.patch, cfg.width - 2 * cfg.patch)
            frame[y : y + cfg.patch, x : x + cfg.patch] += patch * 2.0
            frame[y + cfg.patch // 2, x + cfg.patch // 2] += 1.0  # strong response
    return frame


def match_features(desc: torch.Tensor, valid: torch.Tensor, library: torch.Tensor,
                   threshold: float) -> torch.Tensor:
    """Per library row, the valid frame descriptors within L2 ``threshold``:
    int32 [n_library_rows], through the fused ``match_count`` kernel on
    the card (the [K, L] distance matrix is never written)."""
    return l2_ops.match_count(desc, library, threshold, valid)


def aggregate_matches(match_counts: torch.Tensor, n_logos: int, dpl: int,
                      detect_threshold: int) -> torch.Tensor:
    """Fold per-descriptor matches to per-logo detections (aggregator)."""
    per_logo = match_counts.reshape(n_logos, dpl).sum(dim=1)
    return per_logo >= detect_threshold


def build_vld_operators(cfg: VLDConfig, library, *, device=None):
    """Operators for the StreamEngine: extract -> match -> aggregate.

    Payloads: frame (H, W) numpy -> (desc, valid) -> match_counts ->
    detections.  ``library`` (numpy or tensor) is copied to ``device``
    once.  Returns ``(ops, detections)``; the aggregator appends each
    frame's ``[n_logos]`` bool detections (numpy) to ``detections``.
    """
    from ..engine import Operator

    dev = resolve_device(device)
    lib = torch.as_tensor(np.asarray(library, dtype=np.float32)).to(dev)
    detections: list[np.ndarray] = []

    def extract_fn(frame):
        return [("match", extract_features(torch.as_tensor(frame).to(dev), cfg))]

    def match_fn(payload):
        desc, valid = payload
        return [("aggregate", match_features(desc, valid, lib, cfg.match_threshold))]

    def aggregate_fn(counts):
        det = aggregate_matches(counts, cfg.n_logos, cfg.descriptors_per_logo,
                                cfg.detect_threshold)
        detections.append(det.cpu().numpy())
        return []

    ops = [
        Operator("extract", extract_fn),
        Operator("match", match_fn),
        Operator("aggregate", aggregate_fn),
    ]
    return ops, detections


def build_vld_graph(cfg: VLDConfig, library, *, fps: float = 13.0,
                    mus: tuple[float, float, float] = (2.0, 5.0, 50.0), device=None):
    """The VLD application as an :class:`~repro_torch.api.graph.AppGraph`:
    the chain extract -> match -> aggregate with the frame stream entering
    at the extractor (uniform arrivals, the paper's [1, 25] fps); ``mus``
    are service-rate priors the measurer corrects online.  Returns
    ``(graph, detections)``."""
    from ...api.graph import AppGraph, Edge, OpDef

    ops, detections = build_vld_operators(cfg, library, device=device)
    graph = AppGraph(
        [OpDef(op.name, mu=mu, fn=op.fn) for op, mu in zip(ops, mus)],
        [Edge("extract", "match"), Edge("match", "aggregate")],
        {"extract": fps},
        arrival_kind="uniform",
    )
    return graph, detections
