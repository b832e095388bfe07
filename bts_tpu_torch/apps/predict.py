"""Prediction dumper (bts_test): ``bts_tpu/apps/predict.py`` in PyTorch.

Runs the model over ``cfg.filenames_file`` and writes
``result_<model>/raw/*.png`` uint16 depth maps (x1000 NYU, x256 KITTI), plus
the ``--save_lpg`` visualizations. Data loading, file naming and png writing
are the port's copies of ``bts_tpu``'s; the forward is batched, under
``torch.inference_mode``, in bf16 autocast when ``--compute_dtype bfloat16``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from bts_tpu_torch.config import Config
from bts_tpu_torch.data.loader import EvalLoader
from bts_tpu_torch.data.transforms import denormalize_image
from bts_tpu_torch.utils.colorize import colorize


def output_name(image_path: str, dataset: str) -> str:
    """Filename mangling (pytorch/bts_test.py:146-160)."""
    parts = image_path.split("/")
    if dataset == "kitti":
        # '<date>/<drive>/image_02/data/<file>' -> '<drive>_<file>'
        drive = parts[-4] if len(parts) >= 4 else parts[0]
        return f"{drive}_{parts[-1]}"
    # NYU: '<scene>/rgb_<idx>.jpg' -> '<scene>_rgb_<idx>'
    return "_".join(parts[-2:]) if len(parts) >= 2 else parts[-1]


def save_depth_png(path: str, depth: np.ndarray, dataset: str):
    """uint16 png at the reference scaling (pytorch/bts_test.py:163-173)."""
    scaled = depth * (256.0 if dataset == "kitti" else 1000.0)
    Image.fromarray(scaled.astype(np.uint16)).save(path)


def compute_context(cfg: Config, device: torch.device):
    if cfg.compute_dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be float32 or bfloat16 (got {cfg.compute_dtype!r})")
    return contextlib.nullcontext()


def load_model(cfg: Config, device: torch.device) -> torch.nn.Module:
    """The model of ``cfg.encoder`` seeded from cfg.seed (``models.create_model``),
    then the weights of ``cfg.checkpoint_path`` (a reference or port .pth, or
    a TF checkpoint) when one is set."""
    from bts_tpu_torch.models import create_model
    from bts_tpu_torch.models.convert import load_weights

    model = create_model(cfg)
    if cfg.checkpoint_path:
        model.load_state_dict(load_weights(cfg.checkpoint_path, model, cfg), strict=True)
    return model.to(device).eval()


def forward_padded(model, image: torch.Tensor, focal: torch.Tensor):
    """Edge-pad H and W up to multiples of 32, run, crop the outputs back."""
    h, w = image.shape[-2:]
    ph, pw = (-h) % 32, (-w) % 32
    if ph or pw:
        image = F.pad(image, (0, pw, 0, ph), mode="replicate")
    return [o[..., :h, :w] for o in model(image, focal)]


def run_predictions(cfg: Config, device: torch.device) -> str:
    """Dump predictions for cfg.filenames_file into result_<model_name>/.
    The depth map is the model's last output; ``--save_lpg`` also writes
    the four guidance maps, which only a model whose ``OUTPUTS`` hold them
    has. Returns the output dir."""
    from bts_tpu_torch.models import model_class

    outputs = model_class(cfg.encoder).OUTPUTS
    if cfg.save_lpg and "lpg8x8" not in outputs:
        raise ValueError(f"--save_lpg writes the LPG maps; --encoder {cfg.encoder} returns "
                         f"{outputs}")
    device = torch.device(device)
    model = load_model(cfg, device)
    loader = EvalLoader(cfg, "test")
    normalization = cfg.resolved_normalization
    print(f"{cfg.encoder}: model_flavor {cfg.resolved_flavor}, normalization {normalization}")

    out_dir = f"result_{cfg.model_name}"
    for sub in ("raw", "cmap", "rgb", "gt"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    t0 = time.time()
    n = 0
    for batch in loader.batches():
        image = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).to(device)
        focal = torch.from_numpy(batch["focal"]).to(device)
        with torch.inference_mode(), compute_context(cfg, device):
            outs = forward_padded(model, image, focal)
        outs = [o[:, 0].cpu().numpy() for o in outs]
        depth = outs[-1]
        if not np.isfinite(depth).all():
            raise FloatingPointError("non-finite depth in the model's output")
        for i, w in enumerate(batch["weight"]):
            if w == 0:
                continue
            entry = batch["entries"][i]
            base = os.path.splitext(output_name(entry.image_path, cfg.dataset))[0] + ".png"
            d = depth[i]
            save_depth_png(os.path.join(out_dir, "raw", base), d, cfg.dataset)
            if cfg.save_lpg:
                _save_lpg(cfg, out_dir, base, batch["image"][i], entry, normalization,
                          d, *(o[i] for o in outs[:4]))
            n += 1
    print(f"Saved {n} predictions to {out_dir} in {time.time() - t0:.1f}s on {device}")
    return out_dir


def _save_lpg(cfg, out_dir, base, image, entry, normalization,
              depth, lpg8, lpg4, lpg2, reduc1):
    """Colormapped dumps with a 10px border crop, the denormalized input and,
    for NYU, the gt (as bts_tpu.apps.predict writes them)."""

    def cmap_save(arr, prefix):
        c = colorize(np.maximum(arr[10:-10, 10:-10], 1e-6), cmap="Greys")
        Image.fromarray(c.transpose(1, 2, 0)).save(
            os.path.join(out_dir, "cmap", f"{prefix}_{base}")
        )

    cmap_save(depth, "depth")
    cmap_save(lpg8 * cfg.max_depth, "lpg8x8")
    cmap_save(lpg4 * cfg.max_depth, "lpg4x4")
    cmap_save(lpg2 * cfg.max_depth, "lpg2x2")
    cmap_save(np.maximum(reduc1 * cfg.max_depth, 1e-6), "reduc1x1")
    rgb = np.clip(denormalize_image(np.asarray(image), normalization), 0, 1)[10:-10, 10:-10]
    Image.fromarray((rgb * 255).astype(np.uint8)).save(os.path.join(out_dir, "rgb", base))
    if cfg.dataset == "nyu" and entry.gt_path:
        gt_file = os.path.join(cfg.data_path, entry.gt_path)
        if os.path.exists(gt_file):
            gt = np.asarray(Image.open(gt_file), dtype=np.float32) / 1000.0
            gt[gt == 0] = np.amax(gt)
            c = colorize(gt[10:-10, 10:-10], cmap="Greys")
            Image.fromarray(c.transpose(1, 2, 0)).save(os.path.join(out_dir, "gt", base))
