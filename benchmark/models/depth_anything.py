"""Depth Anything V2, metric (DepthAnything/Depth-Anything-V2, ``--encoder
dav2_vitl``) as the harness reaches it, on both sides of the check; the
contract is in ``models/bts.py``.

The configuration holds upstream's widths under ``vit`` and ``dpt``, and
``input_size`` (``reference/depth_anything.py`` reads them); the program
builds ``bts_tpu_torch.models.depth_anything.DepthAnythingV2Model`` from
the same numbers. The program's global-attention kernel is counted by
``counters``, and its work a call, from the cell's shapes alone, by
``global_attn_calls`` and ``global_attn_work`` (read by
``metrics/global_attn.roofline_pct.py``); ``model_input`` is the frame's
resize, computed from the configuration.
"""

from __future__ import annotations

import copy
import math
import re
from typing import Dict, List, Tuple

import torch

from benchmark.reference.depth_anything import DepthAnythingV2

KEYS = ("encoder", "vit", "dpt", "input_size", "dataset", "max_depth")
# The reference's LayerScale vectors and the program's (upstream's) name for them.
LAYER_SCALE = re.compile(r"(\.ls[12])\.weight$")


def reference(config: dict) -> DepthAnythingV2:
    return DepthAnythingV2(config)


def port_config(config: dict, seed: int):
    """The program's ``Config``, as ``cli.test --encoder dav2_vitl`` parses
    it. Raises at once where the program has no Depth Anything."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models import depth_anything  # noqa: F401  (the program's model)

    return Config(
        encoder=config["encoder"], dataset=config["dataset"], max_depth=config["max_depth"],
        compute_dtype=config["compute_dtype"], normalization=config["normalization"],
        model_flavor="pt", seed=seed, input_height=config["input_height"],
        input_width=config["input_width"],
    )


def port_widths(config: dict) -> dict:
    """The program's ``DepthAnythingV2Model`` arguments for the
    configuration's widths; the program fixes the patch (14), the MLP ratio
    (4), the interpolation offset (0.1), the norms' eps (1e-6) and the
    head's hidden width (32) as upstream does, and
    ``tests/test_harness_depth_anything.py`` holds the configuration to
    them."""
    vit, dpt = config["vit"], config["dpt"]
    return dict(max_depth=config["max_depth"], embed_dim=vit["embed_dim"], depth=vit["depth"],
                num_heads=vit["num_heads"], pos_grid=vit["pos_grid"], taps=tuple(vit["taps"]),
                features=dpt["features"], out_channels=tuple(dpt["out_channels"]),
                input_size=config["input_size"])


def port_model(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """``DepthAnythingV2Model`` built on ``device``, then ``state_dict``
    loaded with ``strict=True``. The one key the harness maps: the
    reference names its LayerScale vectors ``ls1.weight`` and ``ls2.weight``
    so that the seeding rules of ``weights.py`` set them at one, upstream's
    ``init_values``; upstream and the program name them ``gamma``. Its
    forward returns (depth,)."""
    from bts_tpu_torch.models.depth_anything import DepthAnythingV2Model

    with torch.device("meta"):
        model = DepthAnythingV2Model(**port_widths(config))
    model = model.to_empty(device=device)
    model.load_state_dict({LAYER_SCALE.sub(r"\1.gamma", k): v for k, v in state_dict.items()},
                          strict=True)
    return model


def counters() -> Dict[str, int]:
    """The global-attention kernel's launches, which
    ``metrics/global_attn.roofline_pct.py`` holds its trace to."""
    from bts_tpu_torch.ops import global_attention

    return {"global_attn_launches": global_attention.LAUNCHES}


def tiny(config: dict) -> dict:
    """A ViT of embed 128, 2 heads of 64, depth 4 tapped at every block, a
    head of 32 features over 16/32/64/64 channels, a 5x5 position table,
    input size 70, 48x160 frames: resized to 70x238, 5x17 patches, 86
    tokens, so the kernel's last tiles are partial and the table is
    resized."""
    c = copy.deepcopy(config)
    c["vit"].update(embed_dim=128, depth=4, num_heads=2, pos_grid=5, taps=[0, 1, 2, 3])
    c["dpt"].update(features=32, out_channels=[16, 32, 64, 64])
    c.update(input_size=70, input_height=48, input_width=160)
    return c


def model_input(config: dict, h: int, w: int) -> Tuple[int, int]:
    """The model's input for an h x w frame (upstream's ``Resize``, lower
    bound): each side scaled by s = max(input_size / h, input_size / w) and
    rounded to a multiple of the patch, up where rounding falls under
    ``input_size``."""
    size, patch = config["input_size"], config["vit"]["patch_size"]
    s = max(size / h, size / w)

    def side(x):
        y = round(s * x / patch) * patch
        return y if y >= size else math.ceil(s * x / patch) * patch

    return side(h), side(w)


def global_attn_calls(config: dict, batch: int, h: int, w: int
                      ) -> List[Tuple[int, int, int, int]]:
    """(B, heads, N, d) of each global attention of one forward at batch x
    h x w, in launch order: one a block up to the last tapped one; N the
    patches of the model input and the class token."""
    vit = config["vit"]
    mh, mw = model_input(config, h, w)
    n = (mh // vit["patch_size"]) * (mw // vit["patch_size"]) + 1
    d = vit["embed_dim"] // vit["num_heads"]
    return [(batch, vit["num_heads"], n, d)] * (max(vit["taps"]) + 1)


def global_attn_work(config: dict, batch: int, h: int, w: int, elem_bytes: int
                     ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each global attention of one forward: QK^T
    and PV, 2 * 2 * N^2 * d an image and head; q, k and v read and the
    output written once at ``elem_bytes`` an element."""
    return [(4.0 * b * heads * n * n * d, float(elem_bytes * 4 * b * heads * n * d))
            for b, heads, n, d in global_attn_calls(config, batch, h, w)]
