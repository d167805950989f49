"""opt_ms.patch, opt_ms.whole: milliseconds of Adam inside the captured
step (from after the backward to after the optimizer's step), a replay's
mean over the replayed steps of the traced window: the program stamps the
device's clock at four places in the step's CUDA graph, each replay into a
row of its own, and adds up the rows after each epoch's sync (its counters
`step.opt_ms` / `step.stage_readings`)."""

from yardstick.program import ratio


def read(ctx):
    return ratio("step.opt_ms", "step.stage_readings")
