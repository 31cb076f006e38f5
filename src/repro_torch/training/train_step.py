"""The train step (the port of ``repro/training/train_step.py``): loss ->
gradients -> clip -> AdamW -> the new state.

Gradients come from autograd through the model's forward: on the card the
attention, the FFN and the two scans run their Hopper kernels forward and
the plain versions backward (``kernels/flash_attention/grad.py``,
``kernels/swiglu/grad.py``, ``kernels/rwkv6_scan/grad.py``,
``kernels/ssd_scan/grad.py``).  ``compress_grads`` passes the gradients
through int8 quantisation (``distributed/compress.py``) before the update,
as the reference does ahead of its cross-replica reduction.  Every
family trains: dense, moe (the routed experts through autograd of
``torch.bmm`` and the dispatch's gathers, the loss with the load-balancing
term), vlm (the batch also carries ``"patch_embeds"`` and
``"positions_3d"``), ssm, hybrid and audio (the batch also carries
``"frames"``; the encoder's, the decoder's self and its cross attention
all run through ``FlashAttentionFn``).  As the reference's
``jax.checkpoint`` does, the forward rematerialises each layer body --
the decoder's attention + FFN layer, rwkv6's time-mix + channel-mix,
zamba2's norm + mamba2 mixer, whisper's encoder and decoder layers, not
zamba2's shared block -- through a non-reentrant
``torch.utils.checkpoint.checkpoint`` (``models/transformer.py:_run_layer``):
autograd keeps each layer's inputs, and the backward reruns the body, its
kernels included, before it differentiates it.  The gradients are the
same bits.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..distributed.compress import compress_tree, decompress_tree
from ..models.common import ModelConfig
from ..models.transformer import init_params, loss_fn
from ..tree import flatten_with_paths, unflatten
from .optimizer import AdamWConfig, OptState, adamw_init, adamw_update

__all__ = ["TrainState", "TRAINED_FAMILIES", "require_trained", "init_train_state",
           "make_train_step"]

#: The families whose every kernel on the forward has an autograd Function.
TRAINED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: torch.Tensor  # [] int32 global step (mirrors opt.step)


def require_trained(cfg: ModelConfig) -> None:
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"the port does not train the {cfg.family} family ({cfg.arch}); it trains the "
            "dense, moe, vlm, ssm, hybrid and audio families")


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0, *,
                     device=None) -> TrainState:
    """Seeded parameters (:func:`~repro_torch.models.transformer.init_params`
    on ``device``, default the CUDA device), zero moments, step 0.  The
    reference also returns the logical axes: here
    :func:`~repro_torch.models.transformer.param_axes` gives them."""
    params = init_params(cfg, seed, device=device)
    opt = adamw_init(params, opt_cfg)
    return TrainState(params, opt, torch.zeros((), dtype=torch.int32, device=opt.step.device))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, aux_weight: float = 0.01,
                    compress_grads: bool = False):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``"tokens"`` and ``"labels"`` [B, S] on the parameters' device (vlm:
    also ``"patch_embeds"`` and ``"positions_3d"``; audio: ``"frames"``).  The
    parameters and moments are updated in place."""
    require_trained(cfg)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        paths = flatten_with_paths(state.params)
        leaves = [p.detach().requires_grad_() for _key, p in paths]
        params = unflatten(state.params, {key: t for (key, _p), t in zip(paths, leaves)})
        with torch.enable_grad():
            total, metrics = loss_fn(params, cfg, batch, aux_weight=aux_weight)
            grads = torch.autograd.grad(total, leaves)
        grads = unflatten(state.params, {key: g for (key, _p), g in zip(paths, grads)})
        del params, leaves, total
        if compress_grads:
            grads = decompress_tree(compress_tree(grads))
        new_params, new_opt, opt_metrics = adamw_update(state.params, grads, state.opt,
                                                        opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
