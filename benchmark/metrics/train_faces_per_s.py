"""train_faces_per_s.patch, train_faces_per_s.whole: real facets of every
sample the window's steps took over the window's seconds (whole run_epoch
calls, host clock ending in the epoch's sync)."""


def read(ctx):
    if ctx["mode"] != "train":
        return None
    return ctx["counters"]["faces"] / ctx["spans"]["window_s"]
