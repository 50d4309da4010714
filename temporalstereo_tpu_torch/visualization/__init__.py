"""Colour maps of disparities and their errors (numpy)."""
from .colormap import colormap, jet
from .disparity import disp_err_to_colorbar, disp_to_color

__all__ = ["colormap", "disp_err_to_colorbar", "disp_to_color", "jet"]
