from .config import CN, ConfigNode
from .defaults import get_cfg, get_default_config

__all__ = ["CN", "ConfigNode", "get_cfg", "get_default_config"]
