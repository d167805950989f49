"""mfu_pct.train, mfu_pct.eval: useful model FLOPs of the samples the
window's calls took (yardstick/work.py: real edges, valid nodes, the fc
heads; times 3 for a training step's backward) over the window's seconds,
as a percentage of one H100's dense bf16 rate, 989 TF/s.  The card's power
limit is printed beside it."""

PEAK_BF16_FLOPS = 989e12


def read(ctx):
    return 100.0 * ctx["counters"]["useful_flops"] / ctx["spans"]["window_s"] / PEAK_BF16_FLOPS
