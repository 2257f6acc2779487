"""QA prompt construction, tokenized-row packing and answer parsing (own
copy of ``medtok_tpu/qa/prompting.py``): the MCQ system prompt, rows of
[cutoff_len medical-code slots | text ids] with labels masked to the last
token, and the cascaded answer-letter extraction.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

MCQ_INSTRUCTION = (
    "The following is a multiple-choice medical question. Please directly "
    "select and provide the correct answer from options 'A', 'B, 'C', 'D'. "
    "Only return the correct answer by 'A', 'B', 'C', or 'D'."
)


def build_prompt(question: str, chat_template: Callable[[str, str], str] | None = None) -> str:
    """System+user chat prompt; falls back to a plain template when no
    tokenizer chat template is available (offline)."""
    user = "The question is: " + question + "\n Answer: \n"
    if chat_template is not None:
        return chat_template(MCQ_INSTRUCTION, user)
    return f"<<SYS>>{MCQ_INSTRUCTION}<</SYS>>\n{user}assistant\n"


def pack_example(
    prompt_ids: list[int],
    answer_ids: list[int],
    medical_codes: list[int],
    *,
    cutoff_len: int = 256,
    eos_token_id: int | None = None,
    train_on_inputs: bool = False,
) -> dict:
    """[cutoff_len medical slots ‖ text ids] with labels masked to the final
    answer token(s) ([-100]*(n-1)+last, MedTok_fintune_llama3.py:140-154)."""
    ids = (prompt_ids + answer_ids)[:cutoff_len]
    if eos_token_id is not None and len(ids) < cutoff_len and (
        not ids or ids[-1] != eos_token_id
    ):
        ids = ids + [eos_token_id]
    if train_on_inputs:
        labels = list(ids)
    else:
        labels = [-100] * (len(ids) - 1) + ids[-1:]

    med = list(medical_codes)[:cutoff_len]
    med_slots = med + [0] * (cutoff_len - len(med))
    med_mask = [1] * len(med) + [0] * (cutoff_len - len(med))
    return {
        "input_ids": med_slots + ids,
        "attention_mask": med_mask + [1] * len(ids),
        "labels": labels,
    }


def parse_answer(response: str, label: str) -> str:
    """Cascaded answer-letter extraction (MedTok_QA_inference.py:175-209)."""
    if len(response) == 0:
        return "None"
    if label in response[1:]:
        return label
    for marker in (
        "Answer: ", "The correct answer is ", "The correct answer is:",
        "the correct answer is ", "the answer is ", "the answer is: ",
        "assistant ",
    ):
        i = response.find(marker)
        if i >= 0:
            rest = response[i + len(marker):].strip()
            if rest:
                return rest[0]
    return response[0]


def accuracy(predictions: list[str], labels: list[str]) -> float:
    assert len(predictions) == len(labels)
    return float(np.mean([p == l for p, l in zip(predictions, labels)]))
