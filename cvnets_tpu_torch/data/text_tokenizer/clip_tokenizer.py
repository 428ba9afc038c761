"""CLIP's BPE tokenizer in plain Python (counterpart of
cvnets_tpu/data/text_tokenizer/clip_tokenizer.py).

With a merges file (``--text-tokenizer.clip.merges-path``, CLIP's
``bpe_simple_vocab_16e6.txt``, gzipped or not) it is the JAX tokenizer id for
id: the byte → unicode table, the lowercased ASCII word pattern, merges ranked
by their line, ``</w>`` ending a word, ``<|startoftext|>`` / ``<|endoftext|>``
around the ids, truncation to the context length that keeps EOT last, zeros
after it. ``--text-tokenizer.clip.encoder-json-path`` (token → id) wins over the
vocabulary derived from the merges.

Without a merges file a word maps to a bucket of ``vocab_size - 3`` ids. The
JAX package takes ``hash(word)``, which Python salts per process, so a run,
its resume and a later evaluation would each see other ids; here the bucket
is ``zlib.crc32`` of the word's UTF-8 bytes, the same in every process.
"""

from __future__ import annotations

import argparse
import gzip
import html
import json
import os
import re
import zlib
from functools import lru_cache
from typing import Dict, List

import torch

from cvnets_tpu_torch.data.text_tokenizer import TOKENIZER_REGISTRY

SOT, EOT = "<|startoftext|>", "<|endoftext|>"
# merges kept from the file: CLIP's 49,152-entry vocabulary less its bytes and specials
_N_MERGES = 49152 - 256 - 2
# CLIP's \p{L} / \p{N} word pattern restricted to ASCII, as in the JAX package
_WORDS = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                    r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Byte → printable character; bytes without a printable glyph map past 255."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    return re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip()).strip()


@TOKENIZER_REGISTRY.register(name="clip")
class ClipTokenizer:
    def __init__(self, opts, *args, **kwargs) -> None:
        self.opts = opts
        self.context_length = (getattr(opts, "dataset.multi_modal_img_text.context_length", None)
                               or getattr(opts, "model.text.context_length", 77))
        self.vocab_size = getattr(opts, "model.text.vocab_size", 49408)
        self.byte_encoder = bytes_to_unicode()
        merges_path = getattr(opts, "text_tokenizer.clip.merges_path", None)
        self.bpe_ranks = None
        if merges_path and os.path.isfile(merges_path):
            opener = gzip.open if merges_path.endswith(".gz") else open
            with opener(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(m.split()) for m in lines[1:_N_MERGES + 1] if m.strip()]
            vocab = list(self.byte_encoder.values())
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges] + [SOT, EOT]
            self.encoder = {v: i for i, v in enumerate(vocab)}
            enc_json = getattr(opts, "text_tokenizer.clip.encoder_json_path", None)
            if enc_json and os.path.isfile(enc_json):
                with open(enc_json, encoding="utf-8") as f:
                    self.encoder = json.load(f)
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.cache: Dict[str, str] = {}
            self.sot, self.eot = self.encoder[SOT], self.encoder[EOT]
        else:
            self.sot, self.eot = self.vocab_size - 2, self.vocab_size - 1

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        group.add_argument("--text-tokenizer.clip.merges-path", type=str, default=None)
        group.add_argument("--text-tokenizer.clip.encoder-json-path", type=str, default=None,
                           help="Optional token → id json; wins over the vocabulary derived "
                                "from the merges file")
        return parser

    def get_vocab_size(self) -> int:
        return self.vocab_size

    def get_sot_token(self) -> int:
        return self.sot

    def get_eot_token(self) -> int:
        return self.eot

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """The ids of ``text``'s words, without SOT and EOT."""
        ids: List[int] = []
        for token in _WORDS.findall(_clean(text).lower()):
            if self.bpe_ranks is not None:
                tok = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
            else:
                ids.append(zlib.crc32(token.encode("utf-8")) % (self.vocab_size - 3) + 1)
        return ids

    def __call__(self, input_sentence: str) -> torch.Tensor:
        """int64 (context_length,): SOT, the ids, EOT, zeros; cut to the
        context length with EOT kept last."""
        tokens = ([self.sot] + self.encode(input_sentence) + [self.eot])[:self.context_length]
        tokens[-1] = self.eot
        out = torch.zeros(self.context_length, dtype=torch.int64)
        out[:len(tokens)] = torch.tensor(tokens, dtype=torch.int64)
        return out
