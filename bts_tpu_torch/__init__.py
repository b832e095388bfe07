"""BTS in PyTorch for NVIDIA Hopper: the port of ``bts_tpu``'s serving path.

The module layout mirrors ``bts_tpu`` so each module's counterpart is found
under the same name: ``config``, ``ops.lpg`` (with the hand-written CUDA LPG
kernel in ``csrc/lpg.cu``), ``models.{layers,decoder,bts,convert}``,
``models.encoders.densenet``, ``apps.predict`` and ``cli.test``.

Tensors are NCHW inside the models; the LPG functions keep ``bts_tpu``'s
``(B, H, W, 4)`` plane-equation layout. The package imports ``torch`` and
never ``jax``, and nothing of ``bts_tpu``: the host modules it needs
(``config``, ``data.{manifest,transforms,loader}``, ``utils.colorize``,
``apps.predict``'s png helpers) are its own copies.
"""

__version__ = "0.1.0"

from bts_tpu_torch.config import Config, parse_args  # noqa: F401
