from .clip_model import CLIPConfig, RN50, VIT_B16, make_visual_tower
from .convert import from_jax_variables, load_param
from .factory import build_model, clip_config_from_cfg, compute_dtype, make_model
from .reid import ReIDModel

__all__ = [
    "CLIPConfig", "RN50", "ReIDModel", "VIT_B16", "build_model", "clip_config_from_cfg",
    "compute_dtype", "from_jax_variables", "load_param", "make_model",
    "make_visual_tower",
]
