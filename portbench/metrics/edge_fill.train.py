"""The graph encoder's edge fill in training: real edges (after the edge
dropout, for the augmented view) over the B x Epg edge slots of both views
the encoder runs, every batch built in the run (the program's
``graph.edges`` / ``graph.edge_slots`` counters), in %."""

from portbench.fill import fill

MOVES = "train_codes_per_s"


def read(ctx):
    return fill("graph.edges", "graph.edge_slots")
