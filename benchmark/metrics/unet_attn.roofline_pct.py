"""unet_attn.roofline_pct: the denoiser's attention's share of its roofline.

Over the U-Net calls of the traced window, the sum for every self- and
cross-attention of max(operations / peak, bytes / HBM bandwidth), from the
configuration's widths and the cell's batch and input size
(``models/marigold.py``'s ``unet_attn_work``, 32 calls a U-Net call at the
published widths; elements and peak of the configuration's
``compute_dtype``), divided by the device time of the program's kernel,
named here: ``KERNELS``. Reads nothing (no value) where the trace's kernels
are not the launches the program counted, or not every U-Net call's
attentions as one kernel each. Moves ``img_per_s``.
"""

from benchmark.models import marigold

# The program's global-attention kernel (bts_tpu_torch/ops/global_attention.py).
KERNELS = ("global_attn_kernel",)
DTYPES = {"bfloat16": (2, "bf16_flop_per_s"), "float32": (4, "f32_flop_per_s")}


def read(run):
    kernels = run.timeline.kernels(KERNELS)
    if not kernels or run.peaks is None or "unet_attn_launches" not in run.counters:
        return None
    calls = run.counters.get("unet_calls", 0)
    if len(kernels) != run.counters["unet_attn_launches"]:
        return None  # the trace lost launches the program counted
    c, b = run.config, run.traffic["batch"]
    elem_bytes, peak = DTYPES[c["compute_dtype"]]
    work = marigold.unet_attn_work(c, b, c["input_height"], c["input_width"], elem_bytes)
    if not calls or len(kernels) != len(work) * calls:
        return None  # not every U-Net call ran every attention as one kernel
    bound = sum(max(ops / run.peaks[peak], nbytes / run.peaks["hbm_bytes_per_s"])
                for ops, nbytes in work)
    seconds = sum(e - s for _, s, e in kernels) / 1e9
    return 100.0 * bound * calls / seconds
