"""ctypes binding of the native WordPiece tokenizer (``csrc/host/wordpiece.cpp``,
the port's copy of the JAX package's ``data/native_text.py`` over its own
build).

``NativeWordPiece`` wraps a ``WordPieceTokenizer`` vocabulary: ASCII texts
encode in C++; a text the native side rejects (non-ASCII) is encoded by the
Python tokenizer, text by text, so the ids always equal
``data/text.py::WordPieceTokenizer``'s.
"""

from __future__ import annotations

import ctypes

import numpy as np

from medtok_tpu_torch.data import host_build
from medtok_tpu_torch.data.text import WordPieceTokenizer

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = host_build.load("wordpiece")
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.medtok_wp_build.restype = ctypes.c_void_p
    lib.medtok_wp_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.medtok_wp_free.argtypes = [ctypes.c_void_p]
    lib.medtok_wp_encode.restype = ctypes.c_int64
    lib.medtok_wp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_int64]
    lib.medtok_wp_encode_batch.restype = ctypes.c_int64
    lib.medtok_wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int64, i32p, i64p,
        ctypes.c_int64, ctypes.c_int32]
    _lib = lib
    return lib


class NativeWordPiece:
    """``encode`` / ``encode_batch_flat`` / ``encode_batch`` over a
    WordPieceTokenizer's vocabulary."""

    def __init__(self, tokenizer: WordPieceTokenizer):
        self.py = tokenizer
        lib = _load()
        # id -> token, as a '\n'-joined blob in id order
        inv = sorted(tokenizer.vocab.items(), key=lambda kv: kv[1])
        blob = "\n".join(tok for tok, _ in inv).encode("utf-8")
        self._lib = lib
        self._handle = lib.medtok_wp_build(blob, len(blob))
        # grow-only output buffers reused by encode_batch_flat
        self._out = np.empty(0, np.int32)
        self._lens = np.empty(0, np.int64)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.medtok_wp_free(self._handle)
            self._handle = None

    def encode(self, text: str, *, max_length: int = 512,
               pad_to_max: bool = False) -> tuple[np.ndarray, np.ndarray]:
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return self.py.encode(text, max_length=max_length, pad_to_max=pad_to_max)
        out = np.empty(max_length, np.int32)
        n = self._lib.medtok_wp_encode(
            self._handle, raw, len(raw),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_length,
        )
        if n < 0:  # rejected natively: the Python tokenizer encodes it
            return self.py.encode(text, max_length=max_length, pad_to_max=pad_to_max)
        ids = out[:n].copy()
        mask = np.ones(n, np.int32)
        if pad_to_max:
            pad = max_length - n
            ids = np.concatenate([ids, np.full(pad, self.py.pad_id, np.int32)])
            mask = np.concatenate([mask, np.zeros(pad, np.int32)])
        return ids, mask

    def encode_batch_flat(self, texts: list[str], *, max_length: int = 512,
                          num_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Encode ``texts`` on the C++ thread pool (``num_threads`` 0: one a
        hardware thread; the GIL is released for the batch). Returns (ids
        [n, max_length] int32, lens [n] int64): views into buffers that the
        next call reuses. Non-ASCII texts are encoded by the Python
        tokenizer into their rows, so the output equals per-text
        ``encode``."""
        n = len(texts)
        if n == 0:
            return np.zeros((0, max_length), np.int32), np.zeros(0, np.int64)
        raws: list[bytes] = []
        for t in texts:
            try:
                raws.append(t.encode("ascii"))
            except UnicodeEncodeError:
                raws.append(b"\xff")  # a byte the native side rejects
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(r) for r in raws], out=offsets[1:])
        blob = b"".join(raws)
        if self._out.size < n * max_length:
            self._out = np.empty(max(n * max_length, 2 * self._out.size), np.int32)
        if self._lens.size < n:
            self._lens = np.empty(max(n, 2 * self._lens.size), np.int64)
        out = self._out[: n * max_length].reshape(n, max_length)
        lens = self._lens[:n]
        rejects = self._lib.medtok_wp_encode_batch(
            self._handle, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_length, num_threads,
        )
        if rejects:
            for i in np.where(lens < 0)[0]:
                ids = self.py.encode(texts[i], max_length=max_length)[0]
                out[i, : len(ids)] = ids
                lens[i] = len(ids)
        return out, lens

    def encode_batch(self, texts: list[str], *, max_length: int = 512,
                     num_threads: int = 0) -> list[np.ndarray]:
        """Per-text id arrays (over ``encode_batch_flat``)."""
        out, lens = self.encode_batch_flat(texts, max_length=max_length,
                                           num_threads=num_threads)
        return [out[i, : lens[i]].copy() for i in range(len(texts))]

    @property
    def pad_id(self) -> int:
        return self.py.pad_id

    @property
    def vocab(self) -> dict:
        return self.py.vocab
