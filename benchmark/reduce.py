"""Reductions of a traced window that several per-layer readers share."""

from __future__ import annotations


def idle_pct(run):
    """Share of the traced window in which no kernel, copy or set ran on the
    device."""
    if run.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s() / run.timeline.window_s)


def mfu_pct(run, flop_per_unit: float, units: int):
    """Work counted from shapes, done in the traced window, as a share of
    the card's published bf16 peak; None without a peak or without work."""
    if run.peaks is None or units == 0 or run.window_s <= 0:
        return None
    return 100.0 * flop_per_unit * units / run.window_s / run.peaks["bf16_flop_per_s"]
