"""Data layer of the port: the synthetic token stream and the pipelined
loader of the training loop."""

from .pipeline import DataConfig, PipelinedLoader, SyntheticTokens

__all__ = ["DataConfig", "PipelinedLoader", "SyntheticTokens"]
