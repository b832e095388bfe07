"""The system under test, ``bts_tpu_torch``, as the benchmark reaches it.

Everything the harness takes from the program passes through here: its
``Config``, its model loaded from a state dict as a checkpoint reaches it,
and its launch counters. The program is imported inside the functions, so
the reference and the tests of the harness's arithmetic import nothing of it.
"""

from __future__ import annotations

from typing import Dict

import torch


def port_config(config: dict, seed: int):
    """The program's ``Config`` for a benchmark configuration, as
    ``cli.test`` parses it from its arguments."""
    from bts_tpu_torch.config import Config

    return Config(
        encoder=config["encoder"], dataset=config["dataset"], max_depth=config["max_depth"],
        bts_size=config["bts_size"], compute_dtype=config["compute_dtype"],
        normalization=config["normalization"], model_flavor="pt", seed=seed,
        input_height=config["input_height"], input_width=config["input_width"],
    )


def port_model(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """The program's model with ``state_dict`` loaded, as ``cli.test`` and
    ``cli.test`` load a checkpoint: built empty, then ``load_state_dict``
    with ``strict=True``. What the program derives from the weights (folded
    batch norms, packed taps) it derives itself at its first forward."""
    from bts_tpu_torch.models.bts import BTSModel

    with torch.device("meta"):
        model = BTSModel(encoder_name=config["encoder"], max_depth=config["max_depth"],
                         dataset=config["dataset"], bts_size=config["bts_size"])
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def counters() -> Dict[str, int]:
    """The program's own launch counters of the fused dense-layer kernels
    (cumulative in the process)."""
    from bts_tpu_torch.ops import fused_dense_cuda

    return {"taps_launches": fused_dense_cuda.TAPS_LAUNCHES,
            "eo_launches": fused_dense_cuda.EO_LAUNCHES}
