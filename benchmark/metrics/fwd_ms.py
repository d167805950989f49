"""fwd_ms.patch, fwd_ms.whole: milliseconds of the forward and the loss inside the captured
step (from before the forward to after the loss), a replay's mean over the replayed steps of
the traced window: the program stamps the device's clock at four places in
the step's CUDA graph, each replay into a row of its own, and adds up the
rows after each epoch's sync (its counters `step.fwd_ms` /
`step.stage_readings`)."""

from yardstick.program import ratio


def read(ctx):
    return ratio("step.fwd_ms", "step.stage_readings")
