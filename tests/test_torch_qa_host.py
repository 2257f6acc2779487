"""Port vs JAX: the QA host code (prompting, prompter, datasets, extract,
callbacks, mapping) on tests/fixtures/medmcqa_200.json and a small code
vocabulary (``.jsonl`` for the port; the JAX ``CodeMapper`` reads the same
codes from a ``.parquet``, so that case needs pandas and pyarrow)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from medtok_tpu.qa import callbacks as jcallbacks
from medtok_tpu.qa import datasets as jdatasets
from medtok_tpu.qa import extract as jextract
from medtok_tpu.qa import prompter as jprompter
from medtok_tpu.qa import prompting as jprompting
from medtok_tpu_torch.data.dataset import write_jsonl
from medtok_tpu_torch.qa import callbacks, datasets, extract, llama, mapping, prompter, prompting

FIXTURE = Path(__file__).parent / "fixtures" / "medmcqa_200.json"


@pytest.fixture(scope="module")
def rows():
    return datasets.load_qa_rows(FIXTURE)


def _ids(text: str) -> list[int]:
    return [ord(c) % 500 + 10 for c in text]


def test_prompting_matches_jax(rows):
    def template(system, user):
        return f"[{system}|{user}]"

    assert prompting.MCQ_INSTRUCTION == jprompting.MCQ_INSTRUCTION
    for i, r in enumerate(rows):
        q, a = r["input"][:2]
        for chat in (None, template):
            assert prompting.build_prompt(q, chat) == jprompting.build_prompt(q, chat)
        prompt = prompting.build_prompt(q)
        for kw in (dict(cutoff_len=256, eos_token_id=None),
                   dict(cutoff_len=8, eos_token_id=2),
                   dict(cutoff_len=64, eos_token_id=2, train_on_inputs=True)):
            got = prompting.pack_example(_ids(prompt), _ids(a), r["medical_codes"], **kw)
            assert got == jprompting.pack_example(_ids(prompt), _ids(a), r["medical_codes"], **kw)
    responses = ["", "A", "The correct answer is B", "xAnswer: C more", "blah B blah",
                 "the answer is: D.", "assistant  A", "  ", "Q"]
    for resp in responses:
        for label in "ABCD":
            assert prompting.parse_answer(resp, label) == jprompting.parse_answer(resp, label)
    preds = [prompting.parse_answer(r, "A") for r in responses]
    assert prompting.accuracy(preds, ["A"] * len(preds)) == \
        jprompting.accuracy(preds, ["A"] * len(preds))


def test_prompter_matches_jax(tmp_path, rows):
    assert prompter.TEMPLATES == jprompter.TEMPLATES
    custom = {"prompt_input": "I:{instruction} X:{input}", "prompt_no_input": "I:{instruction}",
              "response_split": "=>"}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(custom))
    for template in [*prompter.TEMPLATES, custom, str(path), path]:
        mine, ref = prompter.Prompter(template), jprompter.Prompter(template)
        for r in rows[:20]:
            q, a = r["input"][:2]
            for args in ((q,), (q, "ctx"), (q, None, a), (q, "ctx", a)):
                assert mine.generate_prompt(*args) == ref.generate_prompt(*args)
        out = mine.template["response_split"] + "  B. yes "
        assert mine.get_response(out) == ref.get_response(out) == "B. yes"
    with pytest.raises(ValueError, match="Can't read template"):
        prompter.Prompter("nope")


def test_datasets_match_jax(tmp_path, rows):
    assert rows == jdatasets.load_qa_rows(FIXTURE)
    assert len(rows) == 200
    for r in rows[:10]:
        q = r["input"][0].split("\n")[0]
        assert datasets.format_mcq(q, ["a", "b", "c"]) == jdatasets.format_mcq(q, ["a", "b", "c"])
    bad = tmp_path / "bad.json"
    for content in ([], [{"input": ["q"], "medical_codes": []}], [{"medical_codes": []}]):
        bad.write_text(json.dumps(content))
        with pytest.raises(ValueError):
            datasets.load_qa_rows(bad)

    records = [
        {"tier": "expert", "question_type": "mcq", "question_clean": " What is X? ",
         "answer_options": '{"o1": "a", "o2": "b", "o3": "c"}', "correct_answer": "option2"},
        {"tier": "expert", "question_type": "mcq", "question_clean": "Y?",
         "answer_options": {"o1": "p", "o2": "q"}, "correct_answer": "option1"},
        {"tier": "novice", "question_type": "mcq", "question_clean": "skip me",
         "answer_options": '{"o1": "a"}', "correct_answer": "option1"},
        {"tier": "expert", "question_type": "saq", "question_clean": "Explain Y.",
         "answer_rationale": "Because\nreasons.\r"},
    ]
    (tmp_path / "mine").mkdir()
    (tmp_path / "ref").mkdir()
    for data in ("AfrimedQA-MCQ", "AfrimedQA-SAQ", "mcq_expert"):
        mine = datasets.AfrimedLoader(data, records=records, cache_dir=tmp_path / "mine")
        ref = jdatasets.AfrimedLoader(data, records=records, cache_dir=tmp_path / "ref")
        assert len(mine) == len(ref)
        assert [mine[i] for i in range(len(mine))] == [ref[i] for i in range(len(ref))]
        cached = datasets.AfrimedLoader(data, cache_dir=tmp_path / "mine")
        assert [cached[i] for i in range(len(cached))] == [ref[i] for i in range(len(ref))]
    assert (tmp_path / "mine" / "AfrimedQA_mcq_expert.json").read_text() == \
        (tmp_path / "ref" / "AfrimedQA_mcq_expert.json").read_text()
    with pytest.raises(KeyError):
        datasets.AfrimedLoader("nope", records=records)
    with pytest.raises(FileNotFoundError):
        datasets.AfrimedLoader("AfrimedQA-MCQ")


def test_extract_matches_jax(tmp_path, rows):
    assert extract.EXTRACTION_PROMPT == jextract.EXTRACTION_PROMPT
    reply = ('blah {"Diseases": {"ICD-10": ["E11.9"], "ICD-9": []}, '
             '"Medications": {"ATC": ["J01XA01"], "NDC": [12]}, "Note": "x"} end')
    assert extract.parse_extraction(reply) == jextract.parse_extraction(reply)
    flat = extract.flatten_codes(extract.parse_extraction(reply))
    assert flat == jextract.flatten_codes(jextract.parse_extraction(reply))
    with pytest.raises(ValueError):
        extract.parse_extraction("no json here")

    def client_for(calls):
        def client(prompt):
            calls.append(prompt)
            return "garbage" if len(calls) % 2 else reply
        return client

    questions = [r["input"][0] for r in rows[:6]]
    mine_calls, ref_calls = [], []
    got = extract.extract_dataset(questions, client_for(mine_calls), tmp_path / "mine.json")
    want = jextract.extract_dataset(questions, client_for(ref_calls), tmp_path / "ref.json")
    assert got == want and mine_calls == ref_calls
    assert (tmp_path / "mine.json").read_text() == (tmp_path / "ref.json").read_text()
    assert extract.extract_codes("q", lambda p: "never json") == {} == \
        jextract.extract_codes("q", lambda p: "never json")


def test_callbacks_stream_the_port_generate():
    cfg = llama.TINY_LLAMA
    model = llama.init_llama_(llama.LlamaModel(cfg), torch.Generator().manual_seed(0)).eval()
    emb = torch.as_tensor(np.random.default_rng(9).normal(size=(1, 4, cfg.hidden_size)),
                          dtype=torch.float32)
    mask = torch.ones(1, 4, dtype=torch.long)
    kw = dict(max_new_tokens=5, temperature=0.0, device="cpu")
    toks = list(callbacks.stream_generate(llama.generate, model, emb, mask, **kw))
    assert toks == llama.generate(model, emb, mask, **kw)[0].tolist()
    assert toks == list(jcallbacks.stream_generate(llama.generate, model, emb, mask, **kw))

    def broken(on_token=None):
        on_token(7)
        raise RuntimeError("decode failed")

    stream = callbacks.stream_generate(broken)
    assert next(stream) == 7
    with pytest.raises(RuntimeError, match="decode failed"):
        next(stream)
    streamer = callbacks.TokenStreamer()
    for t in (3, np.int64(4)):
        streamer.put(t)
    streamer.end()
    assert list(streamer) == [3, 4]


VOCAB = ["E11.9", "J01XA01", "A00-B99", "I21.0", "E11.9", "410.01", "C50-C50.9", "Z99"]
CODE_DICTS = [
    {"ICD-10": ["E11.9"]}, {"ATC": ["J01XA01"]}, {"ICD-10": ["A50"]}, {},
    {"ICD-9": ["ZZZ999"]}, {"ICD-10": ["E119", "I21.0", None, "C50.1"], "ATC": []},
    {"ICD-9": ["410.01", "41001"], "NDC": ["Z99"]}, {"ICD-10": []}, {"ATC": ["A10"]},
]


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab")
    cols = {"med_code": VOCAB, "desc": [f"d{i}" for i in range(len(VOCAB))],
            "pkg_index_list": [[i] for i in range(len(VOCAB))]}
    write_jsonl(cols, root / "codes.jsonl")
    return root


def test_mapping_from_jsonl(vocab_files):
    qm = mapping.QueryCodeMapper(mapping.CodeMapper(vocab_files / "codes.jsonl"))
    assert qm.null_id == len(VOCAB)
    assert qm.map_code_dict({"ICD-10": ["E11.9"]}) == [0]
    assert qm.map_code_dict({"ICD-10": ["A50"]}) == [2]     # the range fallback
    assert qm.map_code_dict({}) == [len(VOCAB)]
    assert qm.map_code_dict({"ICD-9": ["410.01"]}) == [5]
    with pytest.raises(ValueError, match=".parquet or a .jsonl"):
        mapping.CodeMapper(vocab_files / "codes.csv")


def test_mapping_matches_jax(vocab_files, tmp_path, rows):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from medtok_tpu.ehr.tasks import CodeMapper as JCodeMapper
    from medtok_tpu.qa.mapping import QueryCodeMapper as JQuery

    pd.DataFrame({"med_code": VOCAB, "pkg_index_list": [[i] for i in range(len(VOCAB))]}
                 ).to_parquet(vocab_files / "codes.parquet")
    ref = JQuery(JCodeMapper(vocab_files / "codes.parquet"))
    for path in ("codes.jsonl", "codes.parquet"):
        mine = mapping.QueryCodeMapper(mapping.CodeMapper(vocab_files / path))
        assert mine.null_id == ref.null_id
        for cd in CODE_DICTS:
            assert mine.map_code_dict(cd) == ref.map_code_dict(cd), cd
        queries = [tuple(r["input"][:2]) for r in rows[:len(CODE_DICTS)]]
        got = mine.build_dataset(queries, CODE_DICTS, tmp_path / "mine.json")
        want = ref.build_dataset(queries, {str(i): d for i, d in enumerate(CODE_DICTS)},
                                 tmp_path / "ref.json")
        assert got == want
        assert (tmp_path / "mine.json").read_text() == (tmp_path / "ref.json").read_text()
