"""input_copies.patch, input_copies.whole, input_copies.eval: tensors copied
into a CUDA graph's static inputs a call, over the traced window (the
program's counters `graph.input_tensors` / `graph.runs`)."""

from yardstick.program import ratio


def read(ctx):
    return ratio("graph.input_tensors", "graph.runs")
