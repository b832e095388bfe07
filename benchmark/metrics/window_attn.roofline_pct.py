"""window_attn.roofline_pct: the window attention's share of its roofline.

Over the forwards of the traced window, the sum for every window attention
of max(operations / peak, bytes / HBM bandwidth), from the configuration's
widths and the cell's batch and input size (``models/newcrfs.py``'s
``window_attn_work``; elements and peak of the configuration's
``compute_dtype``), divided by the device time of the program's kernel,
named here: ``KERNELS``. Reads nothing (no value) where the trace's kernels
are not the launches the program counted, or not every forward's calls.
Moves ``img_per_s``.
"""

from benchmark.models import newcrfs

# The program's window-attention kernel (bts_tpu_torch/ops/window_attention.py).
KERNELS = ("window_attn_kernel",)
DTYPES = {"bfloat16": (2, "bf16_flop_per_s"), "float32": (4, "f32_flop_per_s")}


def read(run):
    kernels = run.timeline.kernels(KERNELS)
    if not kernels or run.peaks is None or "window_attn_launches" not in run.counters:
        return None
    if len(kernels) != run.counters["window_attn_launches"]:
        return None  # the trace lost launches the program counted
    c, b = run.config, run.traffic["batch"]
    elem_bytes, peak = DTYPES[c["compute_dtype"]]
    work = newcrfs.window_attn_work(c, b, c["input_height"], c["input_width"], elem_bytes)
    if len(kernels) != len(work) * run.counts["forwards"]:
        return None  # not every forward ran every window attention as one kernel
    bound = sum(max(ops / run.peaks[peak], nbytes / run.peaks["hbm_bytes_per_s"])
                for ops, nbytes in work)
    seconds = sum(e - s for _, s, e in kernels) / 1e9
    return 100.0 * bound * run.counts["forwards"] / seconds
