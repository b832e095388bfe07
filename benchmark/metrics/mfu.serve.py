"""mfu.serve: the reference's forward FLOPs at the cell's batch and input
size, times the forwards completed in the traced window, over the window's
seconds, as a share of the card's bf16 peak (``peaks.json``). Moves
``img_per_s``."""

from benchmark import flops, reduce


def read(run):
    c, b = run.config, run.traffic["batch"]
    per_forward = flops.forward_flops(c, b, c["input_height"], c["input_width"])
    return reduce.mfu_pct(run, per_forward, run.counts["forwards"])
