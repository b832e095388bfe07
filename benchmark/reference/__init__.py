"""The plain float32 references of the models, and their float8 control."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Keep float32 convolutions and matmuls in float32 on a card inside the
    block, and restore the flags after it, so that a reference's forward
    leaves the program's numerics as they were."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
