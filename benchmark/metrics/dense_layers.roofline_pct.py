"""dense_layers.roofline_pct: the dense layers' share of their roofline.

Over the forwards of the traced window, the sum for every dense layer of
max(operations / bf16 peak, bytes / HBM bandwidth), from DenseNet's
published widths and the cell's batch and input size
(``flops.dense_layer_work``, bf16 elements), divided by the device time of
the kernels that implement the dense layers. Those are named here:
``KERNELS``. Reads nothing (no value) where none of them ran. Moves
``img_per_s``.
"""

from benchmark import flops

# The program's fused dense-layer kernels (bts_tpu_torch/csrc/
# fused_dense_taps_sm90.cu and its float32 twin), by symbol.
KERNELS = ("taps_sm90_kernel", "taps_f32_kernel")
ELEM_BYTES = 2  # bfloat16


def read(run):
    kernels = run.timeline.kernels(KERNELS)
    if not kernels or run.peaks is None or run.config["encoder_arch"]["family"] != "densenet":
        return None
    if len(kernels) != run.counters["taps_launches"] + run.counters["eo_launches"]:
        return None  # the trace lost launches the program counted
    c, b = run.config, run.traffic["batch"]
    work = flops.dense_layer_work(c, b, c["input_height"], c["input_width"], ELEM_BYTES)
    if len(kernels) != len(work) * run.counts["forwards"]:
        return None  # not every forward ran every dense layer as one kernel
    bound = sum(max(ops / run.peaks["bf16_flop_per_s"], nbytes / run.peaks["hbm_bytes_per_s"])
                for ops, nbytes in work)
    seconds = sum(e - s for _, s, e in kernels) / 1e9
    return 100.0 * bound * run.counts["forwards"] / seconds
