"""setup_s: process start to the first timed step (host clock)."""


def read(ctx):
    return ctx["spans"]["setup_s"]
