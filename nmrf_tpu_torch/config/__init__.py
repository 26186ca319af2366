from .config import CfgNode
from .defaults import get_cfg

__all__ = ["CfgNode", "get_cfg"]
