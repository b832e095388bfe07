"""idle_pct.serve: the share of the traced serving window in which no
kernel, copy or set ran on the card (1 - union of their intervals / window).
Moves ``img_per_s``."""

from benchmark import reduce


def read(run):
    return reduce.idle_pct(run)
