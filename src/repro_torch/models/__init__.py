"""Model layer of the port: the dense, moe, vlm, ssm, hybrid and audio
families (see ``transformer.py``), their serving path (``serve``) and the
training loss, and the logical-axis rules (``axis_rules``,
``logical_to_spec``) the dry-run sizes shards with."""

from . import serve
from .common import ModelConfig, axis_rules, cross_entropy_loss, logical_to_spec
from .transformer import forward, init_params, loss_fn

__all__ = [
    "ModelConfig",
    "axis_rules",
    "cross_entropy_loss",
    "logical_to_spec",
    "forward",
    "init_params",
    "loss_fn",
    "serve",
]
