"""Alpaca-family prompt templates and the Prompter formatter (own copy of
``medtok_tpu/qa/prompter.py``). The templates are embedded; a custom
template dict or JSON file is also taken.
"""

from __future__ import annotations

import json
from pathlib import Path

TEMPLATES: dict[str, dict] = {
    "alpaca": {
        "description": "Template used by Alpaca-LoRA.",
        "prompt_input": (
            "Below is an instruction that describes a task, paired with an "
            "input that provides further context. Write a response that "
            "appropriately completes the request.\n\n### Instruction:\n"
            "{instruction}\n\n### Input:\n{input}\n\n### Response:\n"
        ),
        "prompt_no_input": (
            "Below is an instruction that describes a task. Write a response "
            "that appropriately completes the request.\n\n### Instruction:\n"
            "{instruction}\n\n### Response:\n"
        ),
        "response_split": "### Response:",
    },
    "alpaca_short": {
        "description": "A shorter template to experiment with.",
        "prompt_input": (
            "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n"
            "### Response:\n"
        ),
        "prompt_no_input": "### Instruction:\n{instruction}\n\n### Response:\n",
        "response_split": "### Response:",
    },
    # templates/alpaca_legacy.json — same text as alpaca but no trailing
    # newline after "### Response:" (the only difference)
    "alpaca_legacy": {
        "description": "Legacy template, used by Original Alpaca repository.",
        "prompt_input": (
            "Below is an instruction that describes a task, paired with an "
            "input that provides further context. Write a response that "
            "appropriately completes the request.\n\n### Instruction:\n"
            "{instruction}\n\n### Input:\n{input}\n\n### Response:"
        ),
        "prompt_no_input": (
            "Below is an instruction that describes a task. Write a response "
            "that appropriately completes the request.\n\n### Instruction:\n"
            "{instruction}\n\n### Response:"
        ),
        "response_split": "### Response:",
    },
    # templates/vigogne.json — French Alpaca variant
    "vigogne": {
        "description": "French template, used by Vigogne for finetuning.",
        "prompt_input": (
            "Ci-dessous se trouve une instruction qui décrit une tâche, "
            "associée à une entrée qui fournit un contexte supplémentaire. "
            "Écrivez une réponse qui complète correctement la demande.\n\n"
            "### Instruction:\n{instruction}\n\n### Entrée:\n{input}\n\n"
            "### Réponse:\n"
        ),
        "prompt_no_input": (
            "Ci-dessous se trouve une instruction qui décrit une tâche. "
            "Écrivez une réponse qui complète correctement la demande.\n\n"
            "### Instruction:\n{instruction}\n\n### Réponse:\n"
        ),
        "response_split": "### Réponse:",
    },
}


class Prompter:
    def __init__(self, template: str | dict | Path = "alpaca", verbose: bool = False):
        self._verbose = verbose
        if isinstance(template, dict):
            self.template = template
        elif isinstance(template, Path) or (
            isinstance(template, str) and template.endswith(".json")
        ):
            self.template = json.loads(Path(template).read_text())
        else:
            name = template or "alpaca"
            if name not in TEMPLATES:
                raise ValueError(f"Can't read template {name}")
            self.template = TEMPLATES[name]

    def generate_prompt(
        self, instruction: str, input: str | None = None, label: str | None = None
    ) -> str:
        if input:
            res = self.template["prompt_input"].format(
                instruction=instruction, input=input
            )
        else:
            res = self.template["prompt_no_input"].format(instruction=instruction)
        if label:
            res = f"{res}{label}"
        if self._verbose:
            print(res)
        return res

    def get_response(self, output: str) -> str:
        return output.split(self.template["response_split"])[1].strip()
