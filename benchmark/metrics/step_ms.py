"""step_ms.patch, step_ms.whole: CUDA events around every step of the
window, their total over the step count (a mean, not a median)."""


def read(ctx):
    ms = ctx["counters"].get("step_ms")
    if ctx["mode"] != "train" or not ms:
        return None
    return sum(ms) / len(ms)
