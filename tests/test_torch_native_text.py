"""The port's native WordPiece (``medtok_tpu_torch/data/native_text.py`` over
its own build of ``csrc/host/wordpiece.cpp``) against the JAX package's
``NativeWordPiece`` and against the port's Python tokenizer: ASCII,
non-ASCII (encoded by the Python tokenizer), empty and over-``max_length``
texts, one text at a time and in bulk on the C++ thread pool. Texts with
ASCII control characters are held to the JAX package's native route only:
the C++ splits words at them where the Python tokenizer drops them, in the
JAX package as in the port (the last test pins that)."""

import numpy as np
import pytest

from medtok_tpu.data.native_text import NativeWordPiece as JaxNativeWordPiece
from medtok_tpu.data.text import WordPieceTokenizer as JaxWordPiece
from medtok_tpu_torch.data.native_text import NativeWordPiece
from medtok_tpu_torch.data.synthetic import MEDICAL_WORDS, SYLLABLES, synthetic_vocab_columns
from medtok_tpu_torch.data.text import WordPieceTokenizer, make_test_vocab

SPECIAL = [
    "", "   ", "Type 2 diabetes mellitus, without complications.",
    "ACUTE   MYOCARDIAL infarction (STEMI) -- anterior wall!!",
    "Café-au-lait spots", "naïve T-cell lymphoma", "胃 cancer", "x" * 300,
    "hyper" * 40, "a.b,c;d:e?f", "Sjögren syndrome", "unknownword zzzqqq",
    "nephr-itis/neur+itis",
]
CONTROL = ["\tleading\ttabs\nnewline", "a\rb", "x\x00y", "a\x7fb", "a\x0bb"]


@pytest.fixture(scope="module")
def tokenizers():
    vocab = make_test_vocab(MEDICAL_WORDS + SYLLABLES)
    for s in SYLLABLES:
        vocab.setdefault("##" + s, len(vocab))
    py = WordPieceTokenizer(vocab)
    return py, NativeWordPiece(py), JaxNativeWordPiece(JaxWordPiece(vocab))


@pytest.fixture(scope="module")
def texts():
    cols = synthetic_vocab_columns(np.random.default_rng(3), num_codes=600,
                                   num_kg_nodes=100)
    return SPECIAL + cols["desc"]


@pytest.mark.parametrize("max_length", [8, 64, 512])
def test_encode_matches_jax_and_python(tokenizers, texts, max_length):
    py, port, jx = tokenizers
    for text in texts + CONTROL:
        for pad in (False, True):
            got = port.encode(text, max_length=max_length, pad_to_max=pad)
            wants = [jx.encode(text, max_length=max_length, pad_to_max=pad)]
            if text not in CONTROL:
                wants.append(py.encode(text, max_length=max_length, pad_to_max=pad))
            for want in wants:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=repr(text))
    ids, _ = port.encode("x " * 600, max_length=max_length)
    assert len(ids) == max_length and ids[-1] == py.sep_id


@pytest.mark.parametrize("threads", [0, 1, 4])
def test_encode_batch_flat_matches_jax_and_python(tokenizers, texts, threads):
    py, port, jx = tokenizers
    out, lens = port.encode_batch_flat(texts, max_length=32, num_threads=threads)
    want_out, want_lens = jx.encode_batch_flat(texts, max_length=32, num_threads=threads)
    np.testing.assert_array_equal(lens, want_lens)
    assert out.shape == (len(texts), 32) and out.dtype == np.int32
    for i, text in enumerate(texts):
        np.testing.assert_array_equal(out[i, :lens[i]], want_out[i, :want_lens[i]])
        np.testing.assert_array_equal(out[i, :lens[i]], py.encode(text, max_length=32)[0])
    got = port.encode_batch(texts, max_length=32, num_threads=threads)
    assert [len(g) for g in got] == lens.tolist()
    empty_out, empty_lens = port.encode_batch_flat([], max_length=32)
    assert empty_out.shape == (0, 32) and empty_lens.shape == (0,)


def test_non_ascii_goes_through_the_python_tokenizer(tokenizers):
    py, port, _ = tokenizers
    text = "naïve Sjögren"
    assert port.encode(text)[0].tolist() == py.encode(text)[0].tolist()
    out, lens = port.encode_batch_flat([text, "renal", text], max_length=16)
    assert lens[0] == lens[2] == len(py.encode(text, max_length=16)[0])
    assert port.pad_id == py.pad_id and port.vocab is py.vocab


def test_ascii_control_characters_split_natively_and_join_in_python(tokenizers):
    """The JAX package's two routes disagree on ASCII control characters
    (the C++ ends a word at any byte below 0x20 or 0x7f; the Python
    tokenizer drops category Cc, tabs and newlines included, joining the
    words around them), and the port keeps both routes as they are."""
    py, port, jx = tokenizers
    jpy = jx.py
    for text in CONTROL:
        native = port.encode(text)[0]
        np.testing.assert_array_equal(native, jx.encode(text)[0])
        np.testing.assert_array_equal(py.encode(text)[0], jpy.encode(text)[0])
        assert native.tolist() != py.encode(text)[0].tolist(), repr(text)
    assert port.encode("a\tb")[0].tolist() == port.encode("a b")[0].tolist()
    assert py.encode("a\tb")[0].tolist() == py.encode("ab")[0].tolist()
