"""Model layer of the port: the dense, moe, vlm, ssm, hybrid and audio
families (see ``transformer.py``), their serving path (``serve``) and the
training loss.
The reference's logical-axis rules (``axis_rules``, ``logical_to_spec``)
wait for the dry-run (ROADMAP Queue 1 item 6)."""

from . import serve
from .common import ModelConfig, cross_entropy_loss
from .transformer import forward, init_params, loss_fn

__all__ = [
    "ModelConfig",
    "cross_entropy_loss",
    "forward",
    "init_params",
    "loss_fn",
    "serve",
]
