"""agg_roofline_pct.train, agg_roofline_pct.eval: the least time of the
traced window's #1-#6 calls (yardstick/work.py's bound of each call,
summed over the samples the traced calls took) over the device time of the
port's aggregate kernels in the trace, in percent.  The kernel names are
those of geobignn_tpu_torch/csrc/window_*.cuh and node_product.cuh."""

AGGREGATE_KERNELS = ("row_walk_kernel", "col_walk_kernel", "node_product_kernel",
                     "scaled_operand_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = tr.kernel_s(lambda name: any(k in name for k in AGGREGATE_KERNELS))
    if t <= 0.0:
        return None
    return 100.0 * ctx["counters"]["traced_agg_bound_s"] / t
