"""serve.kernel_ms_per_img: milliseconds in which a kernel ran on the card
(the union of the kernels' intervals; copies left out) in the traced serving
window, per image completed in it: the forward's device time, which the
host's copies and dispatch do not move. Moves ``img_per_s``."""


def read(run):
    images = run.counts["images"]
    return 1e3 * run.timeline.kernel_busy_s() / images if images else None
