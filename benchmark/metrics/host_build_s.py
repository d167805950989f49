"""host_build_s: the benchmark's host-clock span around the program's
process_one_mesh calls in set-up (worker processes included)."""


def read(ctx):
    return ctx["spans"].get("host_build_s")
