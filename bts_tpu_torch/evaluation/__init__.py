"""Evaluation: the nine metrics, the masking protocol, device metrics,
online and offline eval (``bts_tpu/evaluation`` in PyTorch)."""

from bts_tpu_torch.evaluation.metrics import EVAL_METRICS, compute_errors  # noqa: F401
