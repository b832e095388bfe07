"""Visualization helpers for dumps (a copy of ``bts_tpu/utils/colorize.py``).

Reference: pytorch/bts_main.py:183-214 (colorize = log10 + matplotlib cmap;
normalize_result = min-max to [0,1]), pytorch/bts_test.py:176-214 (lpg cmap
dumps use log10 + 'Greys').
"""

from __future__ import annotations

import numpy as np


def _get_cmap(name: str):
    try:
        import matplotlib

        return matplotlib.colormaps[name]
    except Exception:  # matplotlib absent or API change — grayscale fallback
        def gray(v, bytes=False):
            v = np.clip(v, 0, 1)
            rgba = np.stack([v, v, v, np.ones_like(v)], axis=-1)
            return (rgba * 255).astype(np.uint8) if bytes else rgba

        return gray


def colorize(value: np.ndarray, vmin=None, vmax=None, cmap="Greys") -> np.ndarray:
    """log10 + colormap -> uint8 CHW image (pytorch/bts_main.py:183-200)."""
    value = np.log10(np.asarray(value, dtype=np.float64))
    vmin = value.min() if vmin is None else vmin
    vmax = value.max() if vmax is None else vmax
    value = (value - vmin) / (vmax - vmin) if vmin != vmax else value * 0.0
    img = _get_cmap(cmap)(value, bytes=True)[:, :, :3]
    return img.transpose((2, 0, 1))


def normalize_result(value: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Min-max normalize to [0,1], 1xHxW (pytorch/bts_main.py:203-214)."""
    value = np.asarray(value, dtype=np.float32)
    value = value.squeeze()
    vmin = value.min() if vmin is None else vmin
    vmax = value.max() if vmax is None else vmax
    value = (value - vmin) / (vmax - vmin) if vmin != vmax else value * 0.0
    return value[None, :, :]
