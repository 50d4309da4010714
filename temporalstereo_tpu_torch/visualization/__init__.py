"""Colour maps of disparities, flows and their errors (numpy)."""
from .colormap import colormap, jet
from .disparity import disp_err_to_color, disp_err_to_colorbar, disp_to_color
from .flow import flow_err_to_color, flow_to_color

__all__ = ["colormap", "disp_err_to_color", "disp_err_to_colorbar",
           "disp_to_color", "flow_err_to_color", "flow_to_color", "jet"]
