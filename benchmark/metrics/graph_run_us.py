"""graph_run_us.patch, graph_run_us.whole, graph_run_us.eval: the program's
own host time in a call of a step's or an eval sample's CUDA graph
(capture.Program): each `graph.run` span of the traced window less the
`graph.replay` spans inside it, that is the signature lookup and check and
the copy into the static inputs without the launch; their mean, in
microseconds.

The launch is left out because the profiler owns most of it: under CUPTI
a graph's launch sets up a record for each of its kernel nodes, and waits
when the launch queue is full.  What is left is still an upper reading of
the program's own host time: the profiler also records each operator of
the copy (the traced against the untraced time of the same calls: PERF.md,
section 3)."""

from yardstick.program import spans


def read(ctx):
    tr = ctx["trace"]
    runs = spans(tr, "graph.run")
    if not runs:
        return None
    replays = spans(tr, "graph.replay")
    own = [(e - s) - sum(re - rs for rs, re in replays if s <= rs and re <= e)
           for s, e in runs]
    return sum(own) / len(own)
