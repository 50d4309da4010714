"""Disparity and optical-flow metrics of the port (tensor ops)."""
from .flow_error import calc_flow_error, do_flow_evaluation
from .pixel_error import calc_error, do_evaluation, do_occlusion_evaluation

__all__ = ["calc_error", "calc_flow_error", "do_evaluation",
           "do_flow_evaluation", "do_occlusion_evaluation"]
