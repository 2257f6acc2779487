"""How unevenly the gate spreads the traced export's tokens: over the MoE
layers, the mean of the busiest expert's tokens over the mean expert's
(1 is even), from the program's device counters
``moe.expert_load.<layer>`` (tokens by expert, kept while the trace ran)."""

MOVES = "export_codes_per_s"


def read(ctx):
    load = ctx.get("expert_load") or {}
    ratios = [max(v) / (sum(v) / len(v)) for v in load.values() if v and sum(v) > 0]
    return sum(ratios) / len(ratios) if ratios else None
