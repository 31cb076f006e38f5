"""The Mamba2 SSD chunked scan (kernel / plain version / dispatch)."""

from .ops import ssd_scan

__all__ = ["ssd_scan"]
