"""The graph encoder's node fill: real nodes of real codes over the B x Ln
node slots of every batch built in the run (the program's
``graph.nodes`` / ``graph.node_slots`` counters; repeat-padding codes
are slots only), in %."""

from portbench.fill import fill

MOVES = "export_codes_per_s"


def read(ctx):
    return fill("graph.nodes", "graph.node_slots")
