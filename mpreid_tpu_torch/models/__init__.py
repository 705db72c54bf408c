from .clip_model import CLIPConfig, RN50, VIT_B16, make_text_tower, make_visual_tower
from .convert import from_jax_variables, load_param
from .factory import (
    build_model, build_model_uniprompt, clip_config_from_cfg, compute_dtype, make_model,
    make_model_uniprompt,
)
from .reid import ReIDModel
from .text import TextTransformer, causal_mask
from .tokenizer import tokenize
from .uniprompt import (
    PromptLearner, UniPromptReID, prompt_template_tokens, view_to_platform_modality,
)

__all__ = [
    "CLIPConfig", "PromptLearner", "RN50", "ReIDModel", "TextTransformer", "UniPromptReID",
    "VIT_B16", "build_model", "build_model_uniprompt", "causal_mask", "clip_config_from_cfg",
    "compute_dtype", "from_jax_variables", "load_param", "make_model", "make_model_uniprompt",
    "make_text_tower", "make_visual_tower", "prompt_template_tokens", "tokenize",
    "view_to_platform_modality",
]
