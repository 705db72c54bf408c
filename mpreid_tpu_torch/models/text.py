"""CLIP text transformer.

ref mpreid_tpu/models/text.py::causal_mask, ::TextTransformer.

Token embedding plus learned positional embedding, L pre-LN blocks under
the causal (upper-triangular -inf) additive mask, ``ln_final``, the hidden
state at the EOT position (the argmax of the token ids), then
``text_projection`` summed in fp32 and rounded to the compute dtype. Two
entry points: ``encode_tokens`` (CLIP ``encode_text``) and
``encode_embeddings`` (the Uni-Prompt ``TextEncoder``: prompt embeddings
in, EOT positions from the tokenized template).

Parameter names follow the reference state_dict of the Uni-Prompt model's
``text_encoder``: ``positional_embedding``, ``transformer.resblocks.{i}.*``,
``ln_final.*``, ``text_projection``, plus ``token_embedding.weight``, which
the reference keeps outside its text encoder (its prompt learner embeds the
template once at init).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, init_normal_, linear_f32acc
from .vit import Transformer


def causal_mask(length: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """Additive (length, length) fp32 mask, -inf above the diagonal."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


class Embedding(nn.Module):
    """Lookup table ``weight`` (num, dim), fp32 (the ``nn.Embedding`` layout)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class TextTransformer(nn.Module):
    def __init__(self, context_length: int, vocab_size: int, width: int, heads: int,
                 layers: int, embed_dim: int, dtype: torch.dtype = torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.width = width
        self.dtype = dtype
        self.token_embedding = Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, dtype, lora_rank, lora_alpha)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        self.register_buffer("mask", causal_mask(context_length), persistent=False)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.token_embedding.weight, 0.02, gen)
        init_normal_(self.positional_embedding, 0.01, gen)
        for block in self.transformer.resblocks:
            block.init_(gen)
        init_normal_(self.text_projection, self.width ** -0.5, gen)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (B, L) → embeddings (B, L, width) in the compute dtype,
        before the positional embedding."""
        return self.token_embedding(tokens).to(self.dtype)

    def _run(self, x: torch.Tensor, eot: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype) + self.positional_embedding.to(self.dtype)
        length = x.shape[1]
        mask = self.mask if length == self.mask.shape[0] else causal_mask(length, x.device)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return linear_f32acc(pooled, self.text_projection.t(), None, self.dtype)

    def encode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """CLIP ``encode_text``: tokens (B, L) → (B, embed_dim)."""
        return self._run(self.embed(tokens), tokens.argmax(dim=-1))

    def encode_embeddings(self, prompt_embeddings: torch.Tensor,
                          tokenized_prompts: torch.Tensor) -> torch.Tensor:
        """The Uni-Prompt ``TextEncoder``: prompt embeddings (B, L, width) →
        (B, embed_dim), pooled at the EOT positions of ``tokenized_prompts``
        (one template row broadcasts over the batch)."""
        eot = tokenized_prompts.argmax(dim=-1)
        if eot.shape[0] == 1 and prompt_embeddings.shape[0] > 1:
            eot = eot.expand(prompt_embeddings.shape[0])
        return self._run(prompt_embeddings, eot)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.encode_tokens(tokens)
