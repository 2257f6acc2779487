"""WordPiece text tokenization (bert-base-uncased semantics), first-party.

Own copy of ``medtok_tpu/data/text.py`` (pure Python): BasicTokenizer +
greedy longest-match-first WordPiece with '##' continuations, [CLS]/[SEP]
wrapping and [UNK] for unmatchable tokens. The port has no C++ fast path.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        *,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_input_chars_per_word = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str | Path, **kw) -> "WordPieceTokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    # ---- BasicTokenizer ----
    def _basic_tokenize(self, text: str) -> list[str]:
        # clean: drop control chars, normalize whitespace
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            if ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
                out.append(" ")
            elif _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        tokens = "".join(out).split()

        result: list[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                # strip accents (NFD, drop Mn)
                tok = "".join(
                    c for c in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(c) != "Mn"
                )
            # split on punctuation
            cur: list[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        result.append("".join(cur))
                        cur = []
                    result.append(ch)
                else:
                    cur.append(ch)
            if cur:
                result.append("".join(cur))
        return result

    # ---- WordPiece ----
    def _wordpiece(self, token: str) -> list[int]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
            cur_id = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur_id = self.vocab[sub]
                    break
                end -= 1
            if cur_id is None:
                return [self.unk_id]
            ids.append(cur_id)
            start = end
        return ids

    def encode(
        self, text: str, *, max_length: int = 512, pad_to_max: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask), [CLS] ... [SEP], truncated to
        max_length; optionally padded to max_length (reference pads always,
        dataset_creator.py:279)."""
        ids = [self.cls_id]
        for tok in self._basic_tokenize(text):
            ids.extend(self._wordpiece(tok))
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        mask = [1] * len(ids)
        if pad_to_max:
            pad = max_length - len(ids)
            ids = ids + [self.pad_id] * pad
            mask = mask + [0] * pad
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


def make_test_vocab(words: list[str]) -> dict[str, int]:
    """Tiny vocab for tests: specials + whole words + single chars."""
    vocab: dict[str, int] = {}
    for t in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]:
        vocab[t] = len(vocab)
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    for c in "abcdefghijklmnopqrstuvwxyz0123456789.,-":
        if c not in vocab:
            vocab[c] = len(vocab)
        cc = "##" + c
        if cc not in vocab:
            vocab[cc] = len(vocab)
    return vocab
