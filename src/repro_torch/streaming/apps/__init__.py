"""The paper's applications on the live engine (VLD; FPD is still to port)."""

from .vld import VLDConfig, build_vld_graph, build_vld_operators

__all__ = ["VLDConfig", "build_vld_graph", "build_vld_operators"]
