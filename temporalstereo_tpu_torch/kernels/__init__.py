"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches per wrapper (plain runs do not count).
"""
from .cost import fused_cost_base, fused_cost_base_plain
from .launches import LAUNCHES, reset_launches
from .splat import summation_splat, summation_splat_plain

__all__ = ["LAUNCHES", "reset_launches", "fused_cost_base",
           "fused_cost_base_plain", "summation_splat", "summation_splat_plain"]
