"""bwd_ms.patch, bwd_ms.whole: milliseconds of the backward inside the captured
step (from after the loss to after the backward), a replay's mean over the replayed steps of
the traced window: the program stamps the device's clock at four places in
the step's CUDA graph, each replay into a row of its own, and adds up the
rows after each epoch's sync (its counters `step.bwd_ms` /
`step.stage_readings`)."""

from yardstick.program import ratio


def read(ctx):
    return ratio("step.bwd_ms", "step.stage_readings")
