"""The text encoder's fill: real tokens over the slots of the packed BERT
rows they were packed into (the program's ``text.tokens`` /
``text.slots`` counters, every packed step of the run), in %."""

from portbench.fill import fill

MOVES = "export_codes_per_s"


def read(ctx):
    return fill("text.tokens", "text.slots")
