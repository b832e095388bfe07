"""global_attn.kernel_ms_per_img: milliseconds in which the program's
global-attention kernel ran on the card (the union of its intervals in the
traced serving window) per image completed in it. A steady device number
that a change to the kernel moves. Moves ``img_per_s``."""

from benchmark.trace import clip, covered

KERNELS = ("global_attn_kernel",)


def read(run):
    t, images = run.timeline, run.counts["images"]
    kernels = t.kernels(KERNELS)
    if not kernels or not images:
        return None
    return 1e3 * covered(clip(((s, e) for _, s, e in kernels), t.start, t.end)) / 1e9 / images
