"""Port vs JAX: the regex-free byte-level BPE tokenizer against the JAX
``BPETokenizer`` (which splits with the ``regex`` package), on a vocabulary
trained by the ``tokenizers`` library as ``tests/test_qa_tokenizer.py``
trains it, under both split patterns (GPT-2 ByteLevel and Llama-3): the
pieces, ids and decode on a corpus, Unicode witnesses and a hypothesis
strategy over code points that ``regex`` and ``unicodedata`` class
alike."""

import copy
import json
import sys
import unicodedata

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from medtok_tpu.qa.tokenizer import LLAMA3_SPLIT_PATTERN as JLLAMA3
from medtok_tpu.qa.tokenizer import BPETokenizer as JBPE
from medtok_tpu_torch.qa import tokenizer as tok
from medtok_tpu_torch.qa.prompting import MCQ_INSTRUCTION, build_prompt
from tests.test_qa_tokenizer import CORPUS, LLAMA_SPECIALS

regex = pytest.importorskip("regex")

WITNESSES = [
    "\x1c\x1d\x1e\x1f separators",            # not White_Space for regex
    "a\x1c b\x1f\n",
    "x\u00b2 + \u00bd = \u216b \u2153 10\u00b3",   # No / Nl numbers
    "e\u0301 cafe\u0301 n\u0303o \u0301x",      # combining marks (Mn)
    "\u6f22\u5b57\u30c6\u30b9\u30c8 \ud55c\uad6d\uc5b4 \u4e2d\u65871234",   # CJK
    "IT'S HE'LL WE'VE I'M THEY'RE 'LL 'S 'D",   # contractions, upper case
    "it's he'll we've 'x 'sa ''s",
    "\u017f '\u017f '\u017ft",                   # LONG S folds to s
    "line\r\n\r\n  next\n\n\n\t\ttabs \r\n",
    "   lead\u00a0\u00a0nbsp\u2009thin\u3000ideo \u0085nel",
    "trailing spaces   ",
    "12345678 1,234.5 -7e10",
    " !!! ?? (x) [y] {z} --> ... ",
    "   para   ",
]


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
    """A tokenizer.json trained by the ``tokenizers`` library (ByteLevel
    pre-tokenizer: the GPT-2 pattern), and a copy whose pre-tokenizer is
    Llama-3's Split + ByteLevel sequence."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    t = Tokenizer(models.BPE())
    t.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    t.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=600, special_tokens=LLAMA_SPECIALS,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    t.train_from_iterator(CORPUS * 4 + WITNESSES * 2, trainer)
    root = tmp_path_factory.mktemp("tok")
    gpt2 = root / "gpt2.json"
    t.save(str(gpt2))
    j = json.loads(gpt2.read_text())
    j3 = copy.deepcopy(j)
    j3["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": JLLAMA3}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}
    j3["model"]["ignore_merges"] = True
    llama3 = root / "llama3.json"
    llama3.write_text(json.dumps(j3))
    return {"gpt2": gpt2, "llama3": llama3}


@pytest.fixture(scope="module", params=["gpt2", "llama3"])
def pair(request, tokenizer_json):
    path = tokenizer_json[request.param]
    return JBPE.from_file(path), tok.BPETokenizer.from_file(path), request.param


SCANNERS = {"gpt2": (tok.GPT2_SPLIT_PATTERN, tok.split_gpt2),
            "llama3": (tok.LLAMA3_SPLIT_PATTERN, tok.split_llama3)}


def _check(pair, text):
    jt, mine, kind = pair
    pattern, scan = SCANNERS[kind]
    assert scan(text) == regex.findall(pattern, text), repr(text)
    ids = mine.encode(text)
    assert ids == jt.encode(text), repr(text)
    assert mine.decode(ids) == jt.decode(ids)
    return ids


@pytest.mark.parametrize("text", CORPUS + WITNESSES)
def test_ids_pieces_and_decode_match_jax(pair, text):
    ids = _check(pair, text)
    assert pair[1].decode(ids) == text


def test_specials_chat_template_and_prompt_match_jax(pair):
    jt, mine, _ = pair
    prompt = build_prompt("What is X?\n A:  one\n B:  two\n", chat_template=mine.chat_template_fn)
    assert prompt == build_prompt("What is X?\n A:  one\n B:  two\n",
                                  chat_template=jt.chat_template_fn)
    assert MCQ_INSTRUCTION in prompt and prompt.startswith("<|begin_of_text|>")
    ids = _check(pair, prompt + "\nB<|eot_id|>")
    assert ids[0] == mine.bos_token_id == jt.bos_token_id
    assert ids[-1] == mine.eos_token_id == jt.eos_token_id
    assert mine.pad_token_id == jt.pad_token_id
    assert mine.decode(ids, skip_special_tokens=True) == jt.decode(ids, skip_special_tokens=True)
    assert mine.encode("hi", add_bos=True) == jt.encode("hi", add_bos=True)


def _agrees(c: str) -> bool:
    """``regex`` and ``unicodedata`` give c the same class (their Unicode
    versions differ on some code points)."""
    cat = unicodedata.category(c)
    return (cat != "Cs"
            and (regex.match(r"\p{L}", c) is not None) == cat.startswith("L")
            and (regex.match(r"\p{N}", c) is not None) == cat.startswith("N"))


CHARS = st.one_of(
    st.sampled_from(list(" \t\r\n\x0b\x0c\x1c\x1f\x85\xa0\u2009\u3000'sStTlLdDmMrReEvV"
                         "\u017f1\u00b2\u00bd\u216ba.!?-\u00e9\u0301\u6f22")),
    st.characters(max_codepoint=sys.maxunicode).filter(_agrees),
)


@settings(max_examples=300, deadline=None, database=None)
@given(text=st.text(CHARS, max_size=40))
def test_scanners_match_regex_on_random_text(text):
    assert tok.split_llama3(text) == regex.findall(tok.LLAMA3_SPLIT_PATTERN, text)
    assert tok.split_gpt2(text) == regex.findall(tok.GPT2_SPLIT_PATTERN, text)


@settings(max_examples=100, deadline=None, database=None)
@given(text=st.text(CHARS, max_size=40))
def test_encode_matches_jax_on_random_text(tokenizer_json, text):
    for path in tokenizer_json.values():
        assert tok.BPETokenizer.from_file(path).encode(text) == JBPE.from_file(path).encode(text)


def test_whitespace_is_the_white_space_set():
    ws = set(regex.findall(r"\s", "".join(map(chr, range(sys.maxunicode + 1)))))
    assert ws == tok.WHITE_SPACE
    assert {"\x1c", "\x1d", "\x1e", "\x1f"} <= {c for c in map(chr, range(64)) if c.isspace()}
    assert tok.char_class("\x1c") == "O"


def test_unknown_split_pattern_is_refused(tmp_path, tokenizer_json):
    j = json.loads(tokenizer_json["gpt2"].read_text())
    j["pre_tokenizer"] = {"type": "Split", "pattern": {"Regex": r"\w+|\s+"}}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(j))
    with pytest.raises(ValueError, match="no scanner"):
        tok.BPETokenizer.from_file(p)
