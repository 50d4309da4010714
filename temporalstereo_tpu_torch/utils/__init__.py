"""Utilities of the port."""
from .convert import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
