"""BTS (cleinc/bts) as the harness reaches it, on both sides of the check.

A configuration names its model with its ``model`` key, and ``spec.model``
imports ``models/<model>.py``. Everything the harness needs of a model, and
nothing else, is in that file, which keeps this contract:

- ``reference(config) -> nn.Module``: the plain float32 reference, built
  from the configuration's published sizes, with ``forward(image, focal) ->
  depth (B, 1, H, W)``. It imports nothing of the program, and its state
  dict's names are the program's. Every convolution and linear layer has a
  ``quant`` attribute (None), a function its input and weight pass through
  when set: the float8 control sets it (``reference/lowp.py``). Its
  parameters and running statistics come from ``weights.py``, by tensor
  kind; the buffers it computes (index tables, masks) its own code makes.
- ``KEYS``: the configuration keys this model needs, beyond those the
  harness reads itself; ``tests/test_harness_spec.py`` holds every
  configuration of the model to them.
- ``port_config(config, seed)``: the program's own configuration, as its
  command line would parse it.
- ``port_model(config, state_dict, device)``: the program's model with
  ``state_dict`` loaded as a checkpoint reaches it. ``state_dict`` holds
  the reference's parameters and running statistics, and no computed
  buffer: the program computes its own. Its forward takes ``(image,
  focal)`` and returns a sequence whose last element is the depth map
  (B, 1, H, W).
- ``counters() -> dict``: the program's launch counters that this model's
  per-layer metrics read, cumulative in the process; the run takes them
  before and after the window.
- ``tiny(config) -> config``: the configuration at the size of the CPU
  tests of the harness.

The program is imported inside the functions, so importing this file loads
nothing of it.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from benchmark.reference.model import BTS

# torchvision's published blocks of the two small members of each family.
DENSENET121 = {"family": "densenet", "block_config": [6, 12, 24, 16], "growth_rate": 32,
               "bn_size": 4, "num_init_features": 64}
RESNEXT50 = {"family": "resnet", "layers": [3, 4, 6, 3], "groups": 32, "width_per_group": 4}

# What the reference and the program are built from, and the published
# training recipe (``train``) that the train cells will run.
KEYS = ("encoder", "encoder_arch", "bts_size", "dataset", "max_depth", "train")


def reference(config: dict) -> BTS:
    return BTS(config)


def port_config(config: dict, seed: int):
    """The program's ``Config``, as ``cli.test`` parses it from its arguments."""
    from bts_tpu_torch.config import Config

    return Config(
        encoder=config["encoder"], dataset=config["dataset"], max_depth=config["max_depth"],
        bts_size=config["bts_size"], compute_dtype=config["compute_dtype"],
        normalization=config["normalization"], model_flavor="pt", seed=seed,
        input_height=config["input_height"], input_width=config["input_width"],
    )


def port_model(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """``BTSModel`` as ``cli.test`` loads a checkpoint: built empty, then
    ``load_state_dict`` with ``strict=True``. What the program derives from
    the weights (folded batch norms, packed taps) it derives itself at its
    first forward. Its forward returns lpg8, lpg4, lpg2, reduc1 and depth."""
    from bts_tpu_torch.models.bts import BTSModel

    with torch.device("meta"):
        model = BTSModel(encoder_name=config["encoder"], max_depth=config["max_depth"],
                         dataset=config["dataset"], bts_size=config["bts_size"])
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def counters() -> Dict[str, int]:
    """The launches of the fused dense-layer kernels, which
    ``metrics/dense_layers.roofline_pct.py`` holds its trace to."""
    from bts_tpu_torch.ops import fused_dense_cuda

    return {"taps_launches": fused_dense_cuda.TAPS_LAUNCHES,
            "eo_launches": fused_dense_cuda.EO_LAUNCHES}


def tiny(config: dict) -> dict:
    """The family's smallest published encoder (DenseNet121 or ResNeXt-50)
    at ``bts_size`` 128 and 64x96 frames."""
    c = copy.deepcopy(config)
    if c["encoder_arch"]["family"] == "densenet":
        c.update(encoder="densenet121_bts", encoder_arch=dict(DENSENET121))
    else:
        c.update(encoder="resnext50_bts", encoder_arch=dict(RESNEXT50))
    c.update(bts_size=128, input_height=64, input_width=96)
    return c
