"""Native WordPiece tokenizer (BERT-base-uncased contract).

The port's own copy of `lavt_rs_tpu/text/tokenizer.py` (importing the JAX
package imports JAX).

The reference depends on a vendored HF transformers v3.0.2 BertTokenizer
(reference README.md:9-13, data/dataset_refer_bert.py:53).  This is a
from-scratch implementation of the same algorithm: BasicTokenizer
(lowercase, accent stripping, punctuation splitting, CJK isolation) +
greedy longest-match-first WordPiece with '##' continuations.

The LAVT encoding contract (reference data/dataset_refer_bert.py:64-76):
  encode(text) = [CLS] wordpieces [SEP], truncated to max_tokens,
  zero-padded; attention mask 1 on real tokens.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Tuple

import numpy as np


def resolve_vocab(vocab_path: str, tokenizer_id: str = "") -> str:
    """Locate the WordPiece vocab file for the CLI flags.

    `--vocab` wins when the file exists; otherwise `--bert_tokenizer` may
    name a vocab.txt directly or a local HF tokenizer directory containing
    one (the reference passes that flag to BertTokenizer.from_pretrained,
    e.g. data/a2d.py:48, test_ytvos.py:170)."""
    if vocab_path and os.path.isfile(vocab_path):
        return vocab_path
    if tokenizer_id:
        if os.path.isfile(tokenizer_id):
            return tokenizer_id
        cand = os.path.join(tokenizer_id, "vocab.txt")
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"no tokenizer vocab found: --vocab {vocab_path!r} does not exist "
        f"and --bert_tokenizer {tokenizer_id!r} is not a local vocab.txt "
        "or a directory containing one")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    """BertTokenizer-compatible tokenizer over a vocab.txt file."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.pad_id = vocab.get("[PAD]", 0)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    # -- basic tokenization ------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        # isolate CJK chars
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    tokens.append("".join(cur)) if cur else None
                    cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return [t for t in tokens if t]

    # -- wordpiece ---------------------------------------------------------

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.vocab[self.unk_token])
               for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.cls_id] + ids + [self.sep_id]
        return ids

    def encode_padded(self, text: str, max_tokens: int = 20
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The LAVT contract: truncate-then-pad to max_tokens with mask."""
        ids = self.encode(text)[:max_tokens]
        padded = np.zeros(max_tokens, np.int32)
        mask = np.zeros(max_tokens, np.int32)
        padded[: len(ids)] = ids
        mask[: len(ids)] = 1
        return padded, mask
