from .device import device_from_cfg, resolve_device
from .logger import setup_logger

__all__ = ["device_from_cfg", "resolve_device", "setup_logger"]
