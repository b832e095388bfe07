"""Marigold v1-0 (prs-eth/Marigold, ``--encoder marigold_v1_0``) as the
harness reaches it, on both sides of the check; the contract is in
``models/bts.py``.

The configuration holds upstream's widths under ``unet``, ``vae`` and
``scheduler``, and ``denoise_steps``, ``processing_res``, ``noise_seed``
and the depth range (``reference/marigold.py`` reads them); the program
builds ``bts_tpu_torch.models.marigold.MarigoldModel`` from the same
numbers. The program's global-attention kernel and its U-Net calls are
counted by ``counters``, under keys of this model's own; the kernel's work
in one U-Net call, from the cell's shapes alone, by ``unet_attn_calls`` and
``unet_attn_work`` (read by ``metrics/unet_attn.roofline_pct.py``);
``model_input`` is the frame's resize, computed from the configuration.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

from benchmark.reference.marigold import Marigold

KEYS = ("encoder", "unet", "vae", "scheduler", "denoise_steps", "processing_res", "noise_seed",
        "dataset", "min_depth", "max_depth")


def reference(config: dict) -> Marigold:
    return Marigold(config)


def port_config(config: dict, seed: int):
    """The program's ``Config``, as ``cli.test --encoder marigold_v1_0``
    parses it. Raises at once where the program has no Marigold."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models import marigold  # noqa: F401  (the program's model)

    return Config(
        encoder=config["encoder"], dataset=config["dataset"], max_depth=config["max_depth"],
        min_depth=config["min_depth"], compute_dtype=config["compute_dtype"],
        normalization=config["normalization"], model_flavor="pt", seed=seed,
        input_height=config["input_height"], input_width=config["input_width"],
    )


def port_widths(config: dict) -> dict:
    """The program's ``MarigoldModel`` arguments for the configuration's
    widths; the program fixes the heads' width (64), the groups (32), the
    norms' eps, the text tokens (77), the latent scale and the scheduler's
    constants as upstream does, and ``tests/test_harness_marigold.py``
    holds the configuration to them."""
    unet, vae = config["unet"], config["vae"]
    return dict(max_depth=config["max_depth"], min_depth=config["min_depth"],
                unet_channels=tuple(unet["block_out_channels"]),
                context_dim=unet["cross_attention_dim"],
                vae_channels=tuple(vae["block_out_channels"]), layers=unet["layers_per_block"],
                latent=vae["latent_channels"], processing_res=config["processing_res"],
                steps=config["denoise_steps"], noise_seed=config["noise_seed"])


def port_model(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """``MarigoldModel`` built on ``device``, then ``state_dict`` loaded
    with ``strict=True`` (the names are the reference's). Its forward
    returns (depth,)."""
    from bts_tpu_torch.models.marigold import MarigoldModel

    with torch.device("meta"):
        model = MarigoldModel(**port_widths(config))
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def counters() -> Dict[str, int]:
    """The global-attention kernel's launches and the U-Net's calls, which
    ``metrics/unet_attn.roofline_pct.py`` holds its trace to."""
    from bts_tpu_torch.models import marigold
    from bts_tpu_torch.ops import global_attention

    return {"unet_attn_launches": global_attention.LAUNCHES, "unet_calls": marigold.UNET_CALLS}


def tiny(config: dict) -> dict:
    """A U-Net of two levels (64 and 128 channels: heads of 64), a VAE of
    two (32 and 64), a context of 64, 2 DDIM steps, processing resolution
    48 and 16x24 frames: processed at 32x48, a 16x24 latent, 384 and 96
    tokens."""
    c = copy.deepcopy(config)
    c["unet"].update(block_out_channels=[64, 128], attention_head_dim=[1, 2],
                     cross_attention_dim=64)
    c["vae"].update(block_out_channels=[32, 64])
    c.update(denoise_steps=2, processing_res=48, input_height=16, input_width=24)
    return c


def model_input(config: dict, h: int, w: int) -> Tuple[int, int]:
    """The processed frame for an h x w frame (upstream's
    ``resize_max_res``): each side times min(res / w, res / h), truncated."""
    s = min(config["processing_res"] / w, config["processing_res"] / h)
    return int(h * s), int(w * s)


def unet_attn_calls(config: dict, batch: int, h: int, w: int
                    ) -> List[Tuple[int, int, int, int, int, int]]:
    """(B, heads, N_q, N_k, d, K and V's batch) of each attention of one
    U-Net call at batch x h x w, in launch order: at each level with
    Transformers, the down path's ``layers`` blocks, then after the mid
    block's one, the up path's ``layers`` + 1; each block a self-attention
    over the level's tokens and a cross-attention to the 77 text tokens,
    whose K and V are one batch's."""
    unet, vae = config["unet"], config["vae"]
    ph, pw = model_input(config, h, w)
    f = 2 ** (len(vae["block_out_channels"]) - 1)
    lh, lw = ph // f, pw // f
    layers, heads = unet["layers_per_block"], unet["attention_head_dim"]
    chans = unet["block_out_channels"]
    levels = len(chans)

    def block(level):
        n = (lh >> level) * (lw >> level)
        hd = heads[level]
        d = chans[level] // hd
        return [(batch, hd, n, n, d, batch), (batch, hd, n, 77, d, 1)]

    calls = []
    for level in range(levels - 1):
        calls += block(level) * layers
    calls += block(levels - 1)
    for level in reversed(range(levels - 1)):
        calls += block(level) * (layers + 1)
    return calls


def unet_attn_work(config: dict, batch: int, h: int, w: int, elem_bytes: int
                   ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each attention of one U-Net call: QK^T and
    PV, 2 * 2 * N_q * N_k * d an image and head; q read and the output
    written once for every image, K and V read once for each of their
    batch, at ``elem_bytes`` an element."""
    return [(4.0 * b * heads * nq * nk * d,
             float(elem_bytes * heads * d * (2 * b * nq + 2 * kv * nk)))
            for b, heads, nq, nk, d, kv in unet_attn_calls(config, batch, h, w)]
