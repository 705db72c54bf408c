from .clip_model import (
    RN50, VIT_B16, CLIPConfig, config_from_state_dict, load_torch_clip, make_text_tower,
    make_visual_tower,
)
from .convert import from_jax_variables, load_param
from .factory import (
    build_model, build_model_uniprompt, clip_config_from_cfg, compute_dtype, graft_clip_weights,
    load_pretrained, make_model, make_model_uniprompt, pretrain_path, switch_to_moe,
)
from .moe import ExpertMLPs, MoEResidualAttentionBlock, load_balancing_loss, topk_routing
from .reid import ReIDModel
from .resnet import ModifiedResNet
from .text import TextTransformer, causal_mask
from .tokenizer import tokenize
from .uniprompt import (
    PromptLearner, UniPromptReID, prompt_template_tokens, view_to_platform_modality,
)

__all__ = [
    "CLIPConfig", "ExpertMLPs", "MoEResidualAttentionBlock", "ModifiedResNet", "PromptLearner",
    "RN50", "ReIDModel", "TextTransformer", "UniPromptReID", "VIT_B16", "build_model",
    "build_model_uniprompt", "causal_mask", "clip_config_from_cfg", "compute_dtype",
    "config_from_state_dict", "from_jax_variables", "graft_clip_weights", "load_balancing_loss",
    "load_param", "load_pretrained", "load_torch_clip", "make_model", "make_model_uniprompt",
    "make_text_tower", "make_visual_tower", "pretrain_path", "prompt_template_tokens",
    "switch_to_moe", "tokenize", "topk_routing", "view_to_platform_modality",
]
