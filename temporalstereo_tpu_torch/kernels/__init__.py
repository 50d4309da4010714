"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; there is no fallback from one to the other.
The cost base, the shift and the splat are ``torch.autograd.Function``s
whose backward is a kernel too; the splat runs a whole softsplat in one
launch, and its whole vjp in one more.
``LAUNCHES`` counts kernel launches per kernel (plain runs do not count);
a CUDA graph's replay adds the launches captured into it.  ``trace_mark``
writes a clock into a ring: the served stream's stage marks.
"""
from .cost import (fused_cost_base, fused_cost_base_backward,
                   fused_cost_base_plain)
from .launches import LAUNCHES, reset_launches
from .mark import trace_mark, trace_mark_plain
from .shift import shift_1d, shift_1d_backward, shift_1d_plain
from .splat import (softsplat, softsplat_plain, softsplat_vjp,
                    softsplat_vjp_plain, splat_plan,
                    summation_splat_vjp_plain)

__all__ = ["LAUNCHES", "reset_launches", "fused_cost_base",
           "fused_cost_base_backward", "fused_cost_base_plain", "shift_1d",
           "shift_1d_backward", "shift_1d_plain", "softsplat",
           "softsplat_plain", "softsplat_vjp", "softsplat_vjp_plain",
           "splat_plan", "summation_splat_vjp_plain", "trace_mark",
           "trace_mark_plain"]
