"""CLIP byte-pair-encoding tokenizer (port of `signal_tpu/models/tokenizer.py`).

CLIP's SimpleTokenizer (`modeling/clip/simple_tokenizer.py` in
maxingan2412/Signal, the stock OpenAI one): reversible byte-level BPE over
a 49,152-merge vocabulary, with <|startoftext|>/<|endoftext|> specials and
77-token context padding (`clip.tokenize`).

The merge table is data. :func:`resolve_bpe_path` looks for it in the
JAX package's order: the ``bpe_path`` argument, then the
``SIGNAL_TPU_BPE_PATH`` environment variable, then the port's own copy
``models/data/bpe_simple_vocab_16e6.txt.gz`` (OpenAI's standard CLIP
vocabulary, byte for byte the JAX package's). With no table a
byte-fallback vocabulary keeps from-scratch training running and warns
once; its ids do not match OpenAI's, so a pretrained text tower refuses it
(``text_encoder.load_clip_text_params``).

The pre-tokenizing pattern matches letters and numbers with ``\\p{L}`` and
``\\p{N}`` when the ``regex`` package is installed, else with an ASCII
pattern: the JAX module's two branches. The JAX module rebinds its ``re``
to ``regex`` when it imports, so with ``regex`` installed every pattern
there (the whitespace clean-up too) runs under ``regex``;
:func:`_pattern_module` makes the same choice here, each time a tokenizer
is built or text is cleaned, from the module flag :data:`_HAS_REGEX`.
"""

from __future__ import annotations

import gzip
import html
import logging
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import torch

try:  # Python's `re` has no \p classes
    import regex as _regex
except ImportError:  # pragma: no cover - the card's host has no `regex`
    _regex = None

_HAS_REGEX = _regex is not None

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "bpe_simple_vocab_16e6.txt.gz")

_PATTERN_UNICODE = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
_PATTERN_ASCII = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                  r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""")

_warned = False


def _pattern_module():
    """``regex`` when :data:`_HAS_REGEX`, else the standard ``re``."""
    return _regex if _HAS_REGEX else re


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte↔unicode map avoiding whitespace and control
    characters (the GPT-2/CLIP construction)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return _pattern_module().sub(r"\s+", " ", text).strip()


def resolve_bpe_path(bpe_path: Optional[str] = None) -> Optional[str]:
    """The merge table: ``bpe_path``, else ``SIGNAL_TPU_BPE_PATH``, else the
    port's copy; None only when none of them exists."""
    for c in (bpe_path, os.environ.get("SIGNAL_TPU_BPE_PATH"), _DATA):
        if c and os.path.exists(c):
            return c
    return None


class ClipTokenizer:
    CONTEXT_LENGTH = 77

    def __init__(self, bpe_path: Optional[str] = None):
        global _warned
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        base_vocab = list(self.byte_encoder.values())
        vocab = base_vocab + [v + "</w>" for v in base_vocab]

        merges: List[Tuple[str, str]] = []
        resolved = resolve_bpe_path(bpe_path)
        if resolved:
            with gzip.open(resolved) as f:
                raw = f.read().decode("utf-8").split("\n")
            merges = [tuple(m.split()) for m in raw[1:49152 - 256 - 2 + 1]]
            vocab += ["".join(m) for m in merges]
        elif not _warned:
            _warned = True
            logging.getLogger("signal_tpu_torch.model").warning(
                "No BPE merge table found (argument, SIGNAL_TPU_BPE_PATH and the "
                "port's copy all missing): using a byte-fallback vocabulary. Token "
                "ids will NOT match OpenAI CLIP; loading a pretrained text tower "
                "with this tokenizer is an error.")

        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        mod = _pattern_module()
        self.pat = mod.compile(_PATTERN_UNICODE if _HAS_REGEX else _PATTERN_ASCII,
                               mod.IGNORECASE)

    @property
    def has_merges(self) -> bool:
        """True when a real merge table loaded (ids match OpenAI CLIP);
        False for the byte-fallback vocabulary."""
        return bool(self.bpe_ranks)

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return word[0]
        pairs = _get_pairs(word)
        if not self.bpe_ranks:
            # the byte-fallback vocabulary stays at byte granularity
            out = " ".join(word)
            self.cache[token] = out
            return out
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
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
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: List[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH) -> torch.Tensor:
        """→ int64 tensor [N, context_length] (`clip.tokenize`)."""
        if isinstance(texts, str):
            texts = [texts]
        result = torch.zeros(len(texts), context_length, dtype=torch.long)
        for i, text in enumerate(texts):
            toks = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(toks) > context_length:
                raise RuntimeError(f"Input too long for context {context_length}: {text!r}")
            result[i, : len(toks)] = torch.tensor(toks)
        return result
