"""The port's QA CLI on the CPU, in-process: ``finetune`` and ``eval`` with
``--tiny --device cpu`` on tests/fixtures/medmcqa_200.json, with the hash
tokenizer and with a byte-level tokenizer.json (the regex-free BPE and the
chat-template route), and the adapter files' layout."""

from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import LLAMA3_SPECIALS, write_tokenizer_json
from medtok_tpu_torch.cli import qa as cli
from medtok_tpu_torch.qa.datasets import load_qa_rows
from medtok_tpu_torch.qa.tokenizer import BPETokenizer

FIXTURE = Path(__file__).parent / "fixtures" / "medmcqa_200.json"
FLAGS = ["--tiny", "--device", "cpu", "--cutoff-len", "16", "--lora-r", "2",
         "--max-new-tokens", "3"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("qa_cli")
    np.save(root / "emb.npy", np.random.default_rng(0).normal(size=(300, 256)).astype(np.float32))
    texts = [r["input"][0] for r in load_qa_rows(FIXTURE)[:40]]
    write_tokenizer_json(root / "tokenizer.json", texts, num_merges=100)
    return root


def _args(files, mode, *extra):
    return [mode, "--data", str(FIXTURE), "--embedding-path", str(files / "emb.npy"),
            *FLAGS, *extra]


@pytest.mark.parametrize("tokenizer", [False, True])
def test_finetune_writes_the_adapter_and_eval_scores(files, tokenizer, tmp_path):
    extra = ["--tokenizer-json", str(files / "tokenizer.json")] if tokenizer else []
    adapter = tmp_path / "adapter"
    out = cli.main(_args(files, "finetune", "--adapter-path", str(adapter), *extra))
    assert len(out["losses"]) == 200 // 16 and np.isfinite(out["losses"]).all()
    proj = np.load(adapter / "projector.npy")
    saved = torch.load(adapter / "lora_params.pt")
    assert proj.shape == (256, 64)      # the JAX layout [256, H]
    np.testing.assert_array_equal(proj, saved["soft_prompt.projector.weight"].numpy().T)
    assert saved["soft_prompt.projector.bias"].shape == (64,)
    for i in range(2):
        for name, out_dim in (("q_proj", 64), ("v_proj", 32)):
            key = f"llm.layers_{i}.self_attn.{name}"
            assert saved[f"{key}.lora_a"].shape == (64, 2)        # [in, r]
            assert saved[f"{key}.lora_b"].shape == (2, out_dim)   # [r, out]
            assert saved[f"{key}.lora_b"].abs().max() > 0
    assert len(saved) == 2 * 2 * 2 + 2
    res = cli.main(_args(files, "eval", *extra))
    assert len(res["predictions"]) == 200 and 0.0 <= res["accuracy"] <= 1.0


def test_the_written_tokenizer_is_byte_level_llama3(files):
    tok = BPETokenizer.from_file(files / "tokenizer.json")
    assert len(tok.vocab) == 256 + 100 + len(LLAMA3_SPECIALS)
    assert max(tok.vocab.values()) < 512
    text = "Which marker persists in chronic hepatitis? Ⅻ\r\n"
    assert tok.decode(tok.encode(text)) == text
    assert len(tok.encode(text)) < len(text.encode())
    prompt = tok.chat_template_fn("sys", "user")
    assert tok.encode(prompt)[0] == tok.bos_token_id


def test_refused_before_the_model_is_built(files, monkeypatch, capsys):
    """--mesh-* above 1 without a process group of the mesh's size stop at
    parse time, naming the torchrun launch; without --tiny a tokenizer file
    is required, and the run stops before building the 8B model."""
    with pytest.raises(SystemExit) as e:
        cli.main(_args(files, "finetune", "--mesh-tp", "2"))
    assert e.value.code == 2 and "torchrun --nproc-per-node 2" in capsys.readouterr().err
    import medtok_tpu_torch.qa.finetune as finetune

    monkeypatch.setattr(finetune, "QAFinetuner", None)
    with pytest.raises(SystemExit, match="--tokenizer-json is required"):
        cli.main(["finetune", "--data", str(FIXTURE), "--embedding-path",
                  str(files / "emb.npy"), "--device", "cpu"])
