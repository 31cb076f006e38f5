"""Helpers of the port's whole-model tests against the JAX package on the
CPU (``tests/test_torch_moe.py``, ``tests/test_torch_vlm.py``,
``tests/test_torch_whisper.py``): the smoke configs of both packages in one
dtype, the JAX parameters carried across, seeded batches (the vlm family's
with patches, the audio family's with frames), and the comparison rule of
``tests/test_torch_dense_archs.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.models.common import mrope_positions
from repro_torch.tree import flatten_with_paths

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: The smoke vlm batch's patches (``tests/test_arch_smoke.py``'s count).
SMOKE_PATCHES = 4


def configs(arch: str, dtype: str, **changes):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jax_get_config(arch, "smoke"), dtype=jd, **changes),
            dataclasses.replace(get_config(arch, "smoke"), dtype=td, **changes))


def models(arch: str, dtype: str, seed: int = 2, **changes):
    jcfg, tcfg = configs(arch, dtype, **changes)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = model_params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def grid_positions(b: int, n_patches: int, s: int) -> np.ndarray:
    """The port's :func:`~repro_torch.models.common.mrope_positions` as
    int32 numpy: qwen2-vl's layout of one image ahead of the text."""
    return mrope_positions(b, n_patches, s).numpy().astype(np.int32)


def batch(cfg, b: int, s: int, seed: int, *, labels: bool = False, positions=None,
          frames: int | None = None) -> dict:
    """Seeded numpy inputs: ``tokens`` [B, S] (and ``labels``); for the vlm
    family ``patch_embeds`` [B, P, D] and ``positions_3d`` ([3, B, P + S];
    default :func:`grid_positions` on a 2 x 2 grid); for the audio family
    ``frames`` [B, S_enc, D] (standard normal; S_enc ``frames``, default
    the config's ``enc_seq``)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((b, SMOKE_PATCHES, cfg.d_model)).astype(
            np.float32)
        out["positions_3d"] = (grid_positions(b, SMOKE_PATCHES, s) if positions is None
                               else positions)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((b, frames or cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    return out


#: The batch's float inputs, given in the model's dtype.
EMBEDDINGS = ("patch_embeds", "frames")


def to_jax(batch: dict, cfg) -> dict:
    return {k: jnp.asarray(v, cfg.dtype) if k in EMBEDDINGS else jnp.asarray(v)
            for k, v in batch.items()}


def to_torch(batch: dict, cfg) -> dict:
    return {k: torch.from_numpy(v).to(cfg.dtype) if k in EMBEDDINGS
            else torch.from_numpy(v).long() for k, v in batch.items()}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, tol: float, dtype: str, rows=None) -> None:
    """float32: |d| <= tol * (1 + |want|); bf16: |d| <= tol * (1 + the
    largest |want| in the last-axis row) (``tests/test_torch_dense_archs.py``'s
    rule).  ``rows`` (bool over the leading axes) limits the check to those
    rows."""
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    assert np.isfinite(got).all()
    if rows is not None:
        got, want = got[rows], want[rows]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    limit = tol * (1 + np.abs(want).max(-1, keepdims=True))
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(limit, want.shape))


#: The router margin (the k-th logit less the (k+1)-th) below which the
#: two packages may route a token differently: in float32 the logits come
#: from the same float32 product (differences ~1e-6); in bf16 they are
#: bf16 products of hidden states that differ by bf16 rounding, and a
#: margin of 1-2 bf16 ulps of the logits (2^-7 at 1) has been seen to
#: route differently.
ROUTE_GAP = {"float32": 1e-5, "bfloat16": 2 ** -5}


def near_ties(routing: list, b: int, dtype: str) -> np.ndarray:
    """bool [B, S]: the tokens whose margin is below ``ROUTE_GAP`` in any
    MoE layer of ``routing`` (a list of the layers' routing dicts of one
    call over B x S tokens, batch-major)."""
    return np.stack([r["margin"].numpy().reshape(b, -1) < ROUTE_GAP[dtype]
                     for r in routing]).any(0)


def leaves(tree, is_leaf=None) -> list:
    return flatten_with_paths(tree, is_leaf=is_leaf)


def shapes_of(spec: dict) -> dict:
    """``param_shapes``' nested dict of (shape, init, scale) as shapes."""
    return {k: shapes_of(v) if isinstance(v, dict) else v[0] for k, v in spec.items()}


def stub_patches(cfg, seed: int, n_patches: int):
    """``TrainLoop``'s ``batch_inputs`` of a vlm model: ``n_patches`` stub
    patch embeddings [B, P, D] (standard normal in ``cfg.dtype``, drawn from
    ``seed`` and the batch's stream position) ahead of its text, and their
    M-RoPE ids [3, B, P + S]."""

    def inputs(position: int, batch: dict) -> dict:
        tokens = batch["tokens"]
        b, s = tokens.shape
        gen = torch.Generator().manual_seed(seed * 1_000_003 + position)
        patches = torch.randn((b, n_patches, cfg.d_model), generator=gen)
        return {"patch_embeds": patches.to(tokens.device, cfg.dtype),
                "positions_3d": mrope_positions(b, n_patches, s, device=tokens.device)}

    return inputs


def stub_frames(cfg, seed: int):
    """``TrainLoop``'s ``batch_inputs`` of an audio model: ``enc_seq`` stub
    frame embeddings [B, S_enc, D] (standard normal in ``cfg.dtype``, drawn
    from ``seed`` and the batch's stream position)."""

    def inputs(position: int, batch: dict) -> dict:
        tokens = batch["tokens"]
        gen = torch.Generator().manual_seed(seed * 1_000_003 + position)
        frames = torch.randn((tokens.shape[0], cfg.enc_seq, cfg.d_model), generator=gen)
        return {"frames": frames.to(tokens.device, cfg.dtype)}

    return inputs


def crash_and_resume(cfg, tmp_path, steps: int = 4, crash: int = 2, batch_inputs=None):
    """``TrainLoop`` on the CPU: a straight run of ``steps`` and a crash at
    ``crash`` resumed to ``steps``; returns (straight losses, resumed
    losses, the leaves whose final parameters differ)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.training.optimizer import AdamWConfig

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=steps)
    data = DataConfig(vocab=cfg.vocab, batch=2, seq_len=16, seed=1)

    def loop(d):
        return TrainLoop(cfg, opt, LoopConfig(total_steps=steps, ckpt_every=crash),
                         ckpt_dir=tmp_path / d, data_cfg=data, batch_inputs=batch_inputs,
                         device="cpu")

    straight = loop("a")
    state_a = straight.run()
    first = loop("b")
    try:
        first.run(crash_at=crash)
    except RuntimeError:
        pass
    second = loop("b")
    state_b = second.run()
    differ = [k for (k, x), (_k, y) in zip(leaves(state_a.params), leaves(state_b.params))
              if not torch.equal(x, y)]
    return ([m["loss"] for m in straight.metrics_history],
            [m["loss"] for m in first.metrics_history + second.metrics_history], differ)
