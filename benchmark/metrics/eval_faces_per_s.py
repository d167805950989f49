"""eval_faces_per_s: real facets of every sample scored in the window over
the window's seconds (whole evaluate passes, host clock ending in the
pass's sync)."""


def read(ctx):
    if ctx["mode"] != "eval":
        return None
    return ctx["counters"]["faces"] / ctx["spans"]["window_s"]
