"""The RWKV6 chunked WKV scan (kernel / plain version / dispatch)."""

from .grad import Rwkv6ScanFn
from .ops import rwkv6_scan

__all__ = ["rwkv6_scan", "Rwkv6ScanFn"]
