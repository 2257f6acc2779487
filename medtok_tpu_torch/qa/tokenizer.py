"""Byte-level BPE tokenizer reading a HF ``tokenizer.json``, without the
``regex`` package (counterpart of ``medtok_tpu/qa/tokenizer.py``).

Vocabulary, ranked merges, the byte <-> printable-unicode map, the added
special tokens and the Llama-3 chat template. The JAX tokenizer splits text
into pieces with the ``regex`` package; this one runs a hand-written
scanner for each of the two split patterns it knows, the Llama-3 one
(``LLAMA3_SPLIT_PATTERN``) and the GPT-2 one of ``ByteLevel``
(``GPT2_SPLIT_PATTERN``), and refuses any other pattern. The scanners take
the alternatives in order, as the regex engine does, with these classes:

- letters (``\\p{L}``) and numbers (``\\p{N}``): the ``unicodedata``
  categories L* and N*;
- whitespace (``\\s``): the Unicode White_Space set, which ``regex`` uses
  (``str.isspace`` also takes U+001C-U+001F, which are not in it);
- the Llama-3 contractions match case-insensitively by simple case folding
  ('S' and U+017F LONG S fold to 's'), the GPT-2 ones as written.

Where the installed ``unicodedata`` and ``regex`` carry different Unicode
versions, a code point assigned in one only may be classed differently.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path

LLAMA3_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# ByteLevel's built-in pattern
GPT2_SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
    r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

WHITE_SPACE = frozenset(map(chr, (
    0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# simple case folding of the contractions' letters
_FOLDED = {"s": "sSſ", "t": "tT", "r": "rR", "e": "eE", "v": "vV", "m": "mM",
           "l": "lL", "d": "dD"}
_NEWLINES = "\r\n"


@functools.lru_cache(maxsize=65536)
def char_class(ch: str) -> str:
    """'W' whitespace, 'L' letter, 'N' number, 'O' anything else."""
    if ch in WHITE_SPACE:
        return "W"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _contraction(text: str, i: int, fold: bool) -> int:
    """End of the contraction starting at i, or -1."""
    if text[i] != "'":
        return -1
    for suffix in _CONTRACTIONS:
        j = i + 1
        for ch in suffix:
            if j < len(text) and (text[j] in _FOLDED[ch] if fold else text[j] == ch):
                j += 1
            else:
                break
        else:
            return j
    return -1


def _run(cls: list[str], j: int, kind: str, limit: int | None = None) -> int:
    """End of the run of class ``kind`` from j (at most ``limit`` long)."""
    end = len(cls) if limit is None else min(len(cls), j + limit)
    while j < end and cls[j] == kind:
        j += 1
    return j


def _whitespace_tail(cls: list[str], i: int) -> int:
    """``\\s+(?!\\S)|\\s+`` at a whitespace character i: the run, less its
    last character when a non-space follows and the run is longer than 1."""
    j = _run(cls, i, "W")
    return j - 1 if j < len(cls) and j - i >= 2 else j


def split_llama3(text: str) -> list[str]:
    """``regex.findall(LLAMA3_SPLIT_PATTERN, text)``."""
    cls = [char_class(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        c = cls[i]
        end = _contraction(text, i, fold=True)
        if end < 0 and c == "L":
            end = _run(cls, i, "L")
        elif end < 0 and c != "N" and text[i] not in _NEWLINES and i + 1 < n \
                and cls[i + 1] == "L":
            end = _run(cls, i + 1, "L")
        elif end < 0 and c == "N":
            end = _run(cls, i, "N", limit=3)
        elif end < 0 and (c == "O" or (text[i] == " " and i + 1 < n and cls[i + 1] == "O")):
            end = _run(cls, i + 1 if c != "O" else i, "O")
            while end < n and text[end] in _NEWLINES:
                end += 1
        elif end < 0:  # whitespace
            j = _run(cls, i, "W")
            last_newline = max((k for k in range(i, j) if text[k] in _NEWLINES), default=-1)
            end = last_newline + 1 if last_newline >= 0 else _whitespace_tail(cls, i)
        out.append(text[i:end])
        i = end
    return out


def split_gpt2(text: str) -> list[str]:
    """``regex.findall(GPT2_SPLIT_PATTERN, text)``."""
    cls = [char_class(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        end = _contraction(text, i, fold=False)
        if end < 0:
            start = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] != "W" else i
            kind = cls[start]
            end = _run(cls, start, kind) if kind != "W" else _whitespace_tail(cls, i)
        out.append(text[i:end])
        i = end
    return out


_SCANNERS = {LLAMA3_SPLIT_PATTERN: split_llama3, GPT2_SPLIT_PATTERN: split_gpt2}


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte<->printable-unicode bijection used by byte-level BPE
    (every byte maps to a visible char so merges operate on strings)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def _extract_split_pattern(pre_tok: dict | None) -> str:
    """The Split pattern of a (possibly Sequence-wrapped) pre_tokenizer
    spec; the Llama-3 pattern by default, the GPT-2 one for a ByteLevel
    step that splits."""
    if not pre_tok:
        return LLAMA3_SPLIT_PATTERN
    kind = pre_tok.get("type")
    if kind == "Sequence":
        for sub in pre_tok.get("pretokenizers", []):
            p = _extract_split_pattern(sub)
            if p is not LLAMA3_SPLIT_PATTERN:
                return p
        return LLAMA3_SPLIT_PATTERN
    if kind == "Split":
        pat = pre_tok.get("pattern", {})
        if "Regex" in pat:
            return pat["Regex"]
    if kind == "ByteLevel" and pre_tok.get("use_regex", True):
        return GPT2_SPLIT_PATTERN
    return LLAMA3_SPLIT_PATTERN


class BPETokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        *,
        special_tokens: dict[str, int] | None = None,
        split_pattern: str = LLAMA3_SPLIT_PATTERN,
        ignore_merges: bool = False,
        add_prefix_space: bool = False,
    ):
        if split_pattern not in _SCANNERS:
            raise ValueError(f"no scanner for the split pattern {split_pattern!r}: only the "
                             "Llama-3 and GPT-2 byte-level patterns are supported")
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        self.id_to_special = {i: t for t, i in self.special_tokens.items()}
        self.ignore_merges = ignore_merges
        self.add_prefix_space = add_prefix_space
        self._split = _SCANNERS[split_pattern]
        self._special_split = (
            re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(
                    self.special_tokens, key=len, reverse=True)) + ")"
            )
            if self.special_tokens else None
        )
        self._b2u = bytes_to_unicode()
        self._u2b = unicode_to_bytes()

    # ------------------------------------------------------------- load ----
    @classmethod
    def from_file(cls, path: str | Path) -> "BPETokenizer":
        j = json.loads(Path(path).read_text(encoding="utf-8"))
        model = j["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"{path}: model type {model.get('type')!r}, want BPE")
        merges = [
            tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
            for m in model["merges"]
        ]
        specials = {
            t["content"]: t["id"]
            for t in j.get("added_tokens", [])
            if t.get("special", True)
        }
        vocab = dict(model["vocab"])
        vocab.update(specials)  # added tokens may extend the vocab
        pre = j.get("pre_tokenizer") or {}
        stack = [pre] + (pre.get("pretokenizers", []) if pre else [])
        add_prefix = any(
            s.get("type") == "ByteLevel" and s.get("add_prefix_space", False)
            for s in stack
        )
        return cls(
            vocab, merges,
            special_tokens=specials,
            split_pattern=_extract_split_pattern(j.get("pre_tokenizer")),
            ignore_merges=model.get("ignore_merges", False),
            add_prefix_space=add_prefix,
        )

    # ------------------------------------------------------------ encode ---
    def _bpe_word(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        # byte-level vocabularies hold every single byte; a piece a
        # malformed vocabulary lacks is dropped
        return [self.vocab[p] for p in parts if p in self.vocab]

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:
        ids: list[int] = []
        if add_bos and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        chunks = (
            self._special_split.split(text) if self._special_split else [text]
        )
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.special_tokens:
                ids.append(self.special_tokens[chunk])
                continue
            for piece in self._split(chunk):
                word = "".join(self._b2u[b] for b in piece.encode("utf-8"))
                ids.extend(self._bpe_word(word))
        return ids

    # ------------------------------------------------------------ decode ---
    def decode(self, ids, *, skip_special_tokens: bool = False) -> str:
        out: list[str] = []
        buf = bytearray()

        def flush():
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            if i in self.id_to_special:
                flush()
                if not skip_special_tokens:
                    out.append(self.id_to_special[i])
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            for ch in tok:
                b = self._u2b.get(ch)
                if b is not None:
                    buf.append(b)
        flush()
        return "".join(out)

    # ----------------------------------------------------------- specials --
    def _special_id(self, *names: str) -> int | None:
        for n in names:
            if n in self.special_tokens:
                return self.special_tokens[n]
        return None

    @property
    def bos_token_id(self) -> int | None:
        return self._special_id("<|begin_of_text|>", "<s>", "<bos>")

    @property
    def eos_token_id(self) -> int | None:
        # Llama-3-Instruct terminates turns with <|eot_id|>
        return self._special_id("<|eot_id|>", "<|end_of_text|>", "</s>", "<eos>")

    @property
    def pad_token_id(self) -> int:
        pid = self._special_id("<|finetune_right_pad_id|>", "<pad>")
        if pid is not None:
            return pid
        return self.eos_token_id if self.eos_token_id is not None else 0

    # ------------------------------------------------------- chat template --
    def apply_chat_template(
        self, messages: list[dict], *, add_generation_prompt: bool = True
    ) -> str:
        """The Llama-3 instruct turn format
        (<|start_header_id|>role<|end_header_id|>\\n\\n content <|eot_id|>),
        as ``tokenizer.apply_chat_template(tokenize=False,
        add_generation_prompt=True)`` renders it."""
        required = ("<|begin_of_text|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eot_id|>")
        missing = [t for t in required if t not in self.special_tokens]
        if missing:
            raise ValueError(
                f"tokenizer lacks Llama-3 chat specials: {missing}"
            )
        parts = ["<|begin_of_text|>"]
        for m in messages:
            parts.append(
                f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                f"{m['content']}<|eot_id|>"
            )
        if add_generation_prompt:
            parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(parts)

    def chat_template_fn(self, system: str, user: str) -> str:
        """(system, user) -> rendered prompt; plugs into
        ``qa.prompting.build_prompt``'s ``chat_template`` argument."""
        return self.apply_chat_template(
            [{"role": "system", "content": system},
             {"role": "user", "content": user}],
            add_generation_prompt=True,
        )
