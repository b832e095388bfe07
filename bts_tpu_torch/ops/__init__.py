"""Op layer: Local Planar Guidance (plain PyTorch and the CUDA kernel)."""

from bts_tpu_torch.ops.lpg import (  # noqa: F401
    decode_plane_eq,
    local_planar_guidance,
    lpg_reference,
    normalize_plane,
)
