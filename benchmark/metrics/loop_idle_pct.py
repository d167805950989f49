"""loop_idle_pct.patch, loop_idle_pct.whole, loop_idle_pct.eval: the share
of the traced window in which the device is idle (no device interval, as
idle_pct) while the program is inside its step or eval loop (the spans
`trainer.steps`, `trainer.eval_steps`), in percent.  idle_pct less it is
the idle at the epochs' or passes' edges and in the harness.

An upper reading of the program's own: under CUPTI each graph launch costs
the host a few microseconds a kernel node, so in the training cells the
host, and not the device, paces the loop while the window is traced
(PERF.md, section 3).  A change of the host's work between replays moves
the reading on top of the profiler's own cost."""

from yardstick.program import spans
from yardstick.trace import complement


def read(ctx):
    tr = ctx["trace"]
    loops = spans(tr, "trainer.steps", "trainer.eval_steps")
    if not loops:
        return None
    lo, hi = tr.window
    # idle inside a loop: what neither a device interval nor the stretches
    # outside every loop cover
    covered = complement(loops, lo, hi) + [(s, e) for _, s, e in tr.clipped()]
    inside = complement(covered, lo, hi)
    return 100.0 * sum(e - s for s, e in inside) * 1e-6 / tr.window_s
