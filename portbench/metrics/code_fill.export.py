"""The quantizer tail's code fill in the export: each packed step's codes
over the power-of-two code bucket its group was padded to by repetition
(the program's ``quantize.codes`` / ``quantize.code_slots`` counters,
every step of the run), in %."""

from portbench.fill import fill

MOVES = "export_codes_per_s"


def read(ctx):
    return fill("quantize.codes", "quantize.code_slots")
