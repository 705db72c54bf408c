from .node import CfgNode
from .defaults import get_default_cfg, cfg, cfg_base

__all__ = ["CfgNode", "get_default_cfg", "cfg", "cfg_base"]
