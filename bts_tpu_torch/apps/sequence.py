"""Directory-of-images inference, the reference's bts_sequence:
``bts_tpu/apps/sequence.py`` in PyTorch.

Reference: tensorflow/bts_sequence.py:59-187. Every '*.png' and '*.jpg' of a
directory goes through the model at batch 1 with a fixed per-dataset focal
(NYU 518.8579, KITTI 718.856, or ``--focal``); the depth and, for a model
whose ``OUTPUTS`` hold them, the three LPG maps are written as colormapped
pngs. Frames of any size are edge-padded to multiples of the model's
``PAD_MULTIPLE`` and the outputs cropped back. The forward runs on the card
(``--device cpu`` for the CPU) under ``inference_mode``, in bf16 autocast
under ``--compute_dtype bfloat16``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from bts_tpu_torch.apps.predict import compute_context, forward_padded, load_model
from bts_tpu_torch.config import Config
from bts_tpu_torch.data.transforms import normalize_image
from bts_tpu_torch.utils.colorize import colorize

DEFAULT_FOCALS = {"nyu": 518.8579, "kitti": 718.856}


def sequence_focal(cfg: Config) -> float:
    if cfg.focal > 0:
        return cfg.focal
    return DEFAULT_FOCALS.get(cfg.dataset, 518.8579)


def run_sequence(cfg: Config, image_dir: str, out_dir: Optional[str] = None,
                 device="cuda") -> int:
    """Process every image in ``image_dir`` (outputs to ``out_dir``, by
    default ``<image_dir>/out``); returns the number processed."""
    device = torch.device(device)
    model = load_model(cfg, device)
    out_dir = out_dir or os.path.join(image_dir, "out")
    os.makedirs(out_dir, exist_ok=True)
    focal = torch.tensor([sequence_focal(cfg)], dtype=torch.float32, device=device)
    normalization = cfg.resolved_normalization  # resolved once

    files = sorted(glob.glob(os.path.join(image_dir, "*.png"))
                   + glob.glob(os.path.join(image_dir, "*.jpg")))
    n = 0
    for path in files:
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        img = normalize_image(img, normalization).astype(np.float32)
        image = torch.from_numpy(img).permute(2, 0, 1)[None].to(device)
        with torch.inference_mode(), compute_context(cfg, device):
            outs = forward_padded(model, image, focal)
        maps = dict(zip(model.OUTPUTS, (o[0, 0].float().cpu().numpy() for o in outs)))
        base = os.path.splitext(os.path.basename(path))[0]
        for name in ("depth", "lpg8x8", "lpg4x4", "lpg2x2"):
            if name not in maps:
                continue
            arr = maps[name] if name == "depth" else maps[name] * cfg.max_depth
            c = colorize(np.maximum(arr, 1e-6), cmap="Greys")
            Image.fromarray(c.transpose(1, 2, 0)).save(os.path.join(out_dir, f"{base}_{name}.png"))
        n += 1
    return n
