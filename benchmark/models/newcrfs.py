"""NeWCRFs (aliyun/NeWCRFs, ``--encoder large07``) as the harness reaches
it, on both sides of the check; the contract is in ``models/bts.py``.

The configuration holds upstream's widths under ``backbone`` and
``decoder`` (``reference/newcrfs.py`` reads them); the program builds
``bts_tpu_torch.models.newcrfs.NeWCRFsModel`` from the same numbers. The
program's window-attention kernel is counted by ``counters``, and its work
a call, from the cell's shapes alone, by ``window_attn_calls`` and
``window_attn_work`` (read by ``metrics/window_attn.roofline_pct.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch

from benchmark.reference.newcrfs import NeWCRFs

KEYS = ("encoder", "backbone", "decoder", "dataset", "max_depth")


def reference(config: dict) -> NeWCRFs:
    return NeWCRFs(config)


def port_config(config: dict, seed: int):
    """The program's ``Config``, as ``cli.test --encoder large07`` parses it.
    Raises at once where the program has no NeWCRFs."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models import newcrfs  # noqa: F401  (the program's model)

    return Config(
        encoder=config["encoder"], dataset=config["dataset"], max_depth=config["max_depth"],
        compute_dtype=config["compute_dtype"], normalization=config["normalization"],
        model_flavor="pt", seed=seed, input_height=config["input_height"],
        input_width=config["input_width"],
    )


def port_widths(config: dict) -> dict:
    """The program's ``NeWCRFsModel`` arguments for the configuration's
    widths; the program fixes the window (7), the CRF levels' depth (2), the
    pool scales, the MLP ratio and the patch as upstream does, and
    ``tests/test_harness_newcrfs.py`` holds the configuration to them."""
    bb, dec = config["backbone"], config["decoder"]
    return dict(max_depth=config["max_depth"], embed_dim=bb["embed_dim"],
                depths=tuple(bb["depths"]), num_heads=tuple(bb["num_heads"]),
                crf_dims=tuple(dec["crf_dims"]), crf_heads=tuple(dec["crf_heads"]),
                psp_channels=dec["channels"], psp_groups=dec["ppm_groups"])


def port_model(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """``NeWCRFsModel`` built on ``device`` (so that it computes its
    ``relative_position_index`` buffers, which a checkpoint also holds and
    the seeded state dict does not), then ``state_dict`` loaded into it; any
    other key missing or unexpected raises. Its forward returns (depth,)."""
    from bts_tpu_torch.models.newcrfs import NeWCRFsModel

    with torch.device(device):
        model = NeWCRFsModel(**port_widths(config))
    computed = {k for k, _ in model.named_buffers() if k.endswith("relative_position_index")}
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if unexpected or set(missing) != computed:
        raise KeyError(f"NeWCRFs state dict: unexpected {unexpected}, missing "
                       f"{sorted(set(missing) - computed)}")
    return model


def counters() -> Dict[str, int]:
    """The window-attention kernel's launches, which
    ``metrics/window_attn.roofline_pct.py`` holds its trace to."""
    from bts_tpu_torch.ops import window_attention

    return {"window_attn_launches": window_attention.LAUNCHES}


def tiny(config: dict) -> dict:
    """Swin at embed 32, depths 2/2/2/2, heads 1/2/4/8, CRF dims
    64/128/256/512 with heads 2/4/8/16 (head dim 32 throughout; the CRF
    widths differ from Swin's, as in ``large07``, so every level has its
    ``proj_x``), a 64-channel PSP, 64x96 frames: the token maps are 16x24
    down to 2x3, so padding and the shift mask both occur."""
    c = copy.deepcopy(config)
    c["backbone"].update(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8])
    c["decoder"].update(channels=64, ppm_groups=32, crf_dims=[64, 128, 256, 512],
                        crf_heads=[2, 4, 8, 16], v_dims=[32, 64, 128, 64])
    c.update(input_height=64, input_width=96)
    return c


def window_attn_calls(config: dict, batch: int, h: int, w: int
                      ) -> List[Tuple[int, int, int, bool, int, int]]:
    """(windows, heads, nW, shifted, N, d) of each window attention of one
    forward at batch x h x w, in launch order: Swin's blocks stage by stage,
    then the CRF levels from crf3 to crf0, each level's blocks alternating
    shift 0 and window // 2. nW is the windows an image, N a window's
    tokens, d the head dimension."""
    bb, dec = config["backbone"], config["decoder"]
    grids = [(-(-h // bb["patch_size"]), -(-w // bb["patch_size"]))]
    for _ in bb["depths"][1:]:
        grids.append(((grids[-1][0] + 1) // 2, (grids[-1][1] + 1) // 2))

    def level(grid, window, depth, heads, dim):
        n_w = -(-grid[0] // window) * -(-grid[1] // window)
        return [(batch * n_w, heads, n_w, i % 2 == 1, window * window, dim // heads)
                for i in range(depth)]

    calls = []
    for i, depth in enumerate(bb["depths"]):
        calls += level(grids[i], bb["window_size"], depth, bb["num_heads"][i],
                       bb["embed_dim"] * 2 ** i)
    for i in reversed(range(len(dec["crf_dims"]))):
        calls += level(grids[i], dec["crf_window"], dec["crf_depth"], dec["crf_heads"][i],
                       dec["crf_dims"][i])
    return calls


def window_attn_work(config: dict, batch: int, h: int, w: int, elem_bytes: int
                     ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each window attention of one forward: QK^T
    and PV, 2 * 2 * N^2 * d a window and head; q, k, v read and the output
    written once at ``elem_bytes`` an element, the float32 bias table, the
    int64 index and, for a shifted block, the float32 mask, each once."""
    out = []
    for windows, heads, n_w, shifted, n, d in window_attn_calls(config, batch, h, w):
        side = 2 * int(round(n ** 0.5)) - 1
        ops = 4.0 * windows * heads * n * n * d
        nbytes = (elem_bytes * 4 * windows * heads * n * d + 4 * side * side * heads
                  + 8 * n * n + (4 * n_w * n * n if shifted else 0))
        out.append((ops, float(nbytes)))
    return out
