"""Byte-level BPE tokenizer compatible with OpenAI CLIP.

ref mpreid_tpu/models/tokenizer.py::ClipTokenizer, ::tokenize (the
published CLIP algorithm over the standard ``bpe_simple_vocab_16e6`` merge
table, vocab 49408 with ``<|startoftext|>``/``<|endoftext|>``). The port
keeps its own byte-identical copy of the merge table in ``assets/``.

The port needs neither ``regex`` nor ``ftfy``, which the card's machine
may lack:

* text cleaning is the JAX module's ftfy-less branch: two HTML unescapes,
  NFC normalisation, whitespace collapse, lower case;
* the split pattern uses the stdlib ``re``: ``[^\\W\\d_]+`` for ``\\p{L}+``,
  ``\\d`` for ``\\p{N}`` and ``(?:[^\\s\\w]|_)+`` for
  ``[^\\s\\p{L}\\p{N}]+``.

``\\p{N}`` also takes numbers that are not decimal digits (Unicode
categories No and Nl, such as ``²``, ``½``, ``Ⅻ``), one character at a
time, where the stdlib's ``\\w`` would keep them in a word (``"x²"`` is two
pieces there); so ``encode`` cuts the text around each such character before
the pattern runs, and no other alternative of the JAX pattern spans one. The
ids equal the JAX ``tokenize``'s (``tests/test_torch_tokenizer.py``).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "bpe_simple_vocab_16e6.txt.gz")

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408

_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d"""
            r"""|(?:[^\s\w]|_)+""")


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte↔unicode map used by GPT-2-style byte-level BPE."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipTokenizer:
    def __init__(self, bpe_path: str = _ASSET):
        byte_encoder = bytes_to_unicode()
        self.byte_encoder = byte_encoder
        self.byte_decoder = {v: k for k, v in byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(_PATTERN, re.IGNORECASE)
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        tokens = []
        for piece in _split_non_decimal(_clean_text(text)):
            tokens.extend([piece] if _is_non_decimal(piece) else self.pat.findall(piece))
        for token in tokens:
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def _is_non_decimal(piece: str) -> bool:
    return len(piece) == 1 and unicodedata.category(piece) in ("No", "Nl")


def _split_non_decimal(text: str) -> List[str]:
    """``text`` cut before and after every No/Nl character, which ``\\p{N}``
    takes alone."""
    pieces, start = [], 0
    for i, ch in enumerate(text):
        if _is_non_decimal(ch):
            pieces.extend(p for p in (text[start:i], ch) if p)
            start = i + 1
    if start < len(text):
        pieces.append(text[start:])
    return pieces


@functools.lru_cache()
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = False) -> np.ndarray:
    """Texts → (N, context_length) int32 array with SOT/EOT framing."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = tok.eot_token
            else:
                raise RuntimeError(f"Input {text} is too long for context length {context_length}")
        result[i, : len(tokens)] = tokens
    return result
