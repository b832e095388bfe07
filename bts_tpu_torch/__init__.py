"""BTS in PyTorch for NVIDIA Hopper: the port of ``bts_tpu``'s serving,
training and evaluation paths.

The module layout mirrors ``bts_tpu`` so each module's counterpart is found
under the same name: ``config``, ``ops.lpg`` (with the hand-written CUDA LPG
kernels in ``csrc/lpg.cu`` and the native CPU LPG, ``ops.lpg_cpu``),
``ops.fused_dense``, ``models.{layers,decoder,bts,convert,convert_tf}``,
``models.encoders.{densenet,resnet,mobilenet}``, ``data`` (with
``data.tools``), ``training``, ``evaluation``,
``apps.{predict,sequence,live3d,live3d_gl}``,
``cli.{test,train,eval,eval_with_pngs,eval_schedule,sequence,live3d,avg_checkpoints}``
and ``tools.reproduce_reference``.

Tensors are NCHW inside the models; the LPG functions keep ``bts_tpu``'s
``(B, H, W, 4)`` plane-equation layout. The package imports ``torch`` and
never ``jax`` (``tensorflow`` only inside the functions that read a TF
checkpoint), and nothing of ``bts_tpu``: the host modules it needs
(``config``, ``data.{manifest,transforms,loader}``, ``utils.colorize``,
``apps.predict``'s png helpers, ``evaluation.{protocol,png_eval}``, the
numpy parts of ``apps.{live3d,live3d_gl}``) are its own copies.
"""

__version__ = "0.1.0"

from bts_tpu_torch.config import Config, parse_args  # noqa: F401
