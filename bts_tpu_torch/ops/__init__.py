"""Op layer: Local Planar Guidance (plain PyTorch and the CUDA kernel), and
the registry of the hand-written kernels' launch counters."""

import sys

from bts_tpu_torch.ops.lpg import (  # noqa: F401
    decode_plane_eq,
    local_planar_guidance,
    lpg_reference,
    normalize_plane,
)

# Every kernel's launch counters, "<module>.<attribute>" -> (module,
# attribute): module attributes that their kernel module registers at import
# (``count_launches``). A counter counts launches that ran: its module bumps
# it once a launch, and a CUDA graph's replay (``models/graphed.py``) adds
# the launches its capture recorded; a capture itself counts nothing.
LAUNCH_COUNTERS = {}


def count_launches(module_name: str, *attributes: str) -> None:
    """Register the launch counters ``attributes`` of the module being
    imported (``count_launches(__name__, "LAUNCHES")``)."""
    for attribute in attributes:
        LAUNCH_COUNTERS[f"{module_name}.{attribute}"] = (sys.modules[module_name], attribute)
