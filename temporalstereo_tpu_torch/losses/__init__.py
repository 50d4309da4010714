"""Training losses of the port."""
from .smooth_l1 import DispSmoothL1Loss, smooth_l1
from .wasserstein import WassersteinDistanceLoss

__all__ = ["DispSmoothL1Loss", "WassersteinDistanceLoss", "smooth_l1"]
