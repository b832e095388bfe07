"""Configuration for the port: ``bts_tpu``'s ``Config`` and flag surface.

``Config`` and the argument parser are ``bts_tpu.config``'s, so reference and
``bts_tpu`` args files carry over unchanged. ``parse_args`` differs in one
way: ``Config.validate`` resolves ``model_flavor auto`` and ``normalization
auto`` by sniffing the checkpoint files, which imports jax-backed modules of
``bts_tpu``. The port checks what it supports itself and pins both fields to
concrete values, so nothing sniffs afterwards.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence, Tuple

from bts_tpu.config import Config, _build_parser


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    """Parse CLI args (or a single args-file path) into a checked Config."""
    return parse_args_with_device(argv)[0]


def parse_args_with_device(argv: Optional[Sequence[str]] = None) -> Tuple[Config, str]:
    """As ``parse_args``, also returning the ``--device`` flag ('' if unset)."""
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    if len(argv) == 1 and not argv[0].startswith("-"):
        argv = ["@" + argv[0]]
    parser = _build_parser()
    parser.add_argument(
        "--device",
        default="",
        help="torch device; default 'cuda' (fails without a card). "
        "'cpu' runs the plain PyTorch ops, for tests.",
    )
    ns = vars(parser.parse_args(argv))
    device = ns.pop("device")
    return _check(Config(**ns)), device


def _check(cfg: Config) -> Config:
    from bts_tpu_torch.models.bts import check_encoder
    from bts_tpu_torch.ops.lpg import check_impl

    if cfg.dataset not in ("nyu", "kitti"):
        raise ValueError(f"dataset must be 'nyu' or 'kitti' (got {cfg.dataset!r})")
    check_impl(cfg.lpg_impl)
    check_encoder(cfg.encoder)
    if cfg.model_flavor == "tf":
        raise NotImplementedError(
            "model_flavor 'tf' is not ported yet: ROADMAP.md queue 1, item 14"
        )
    if cfg.model_flavor not in ("pt", "auto"):
        raise ValueError(
            f"model_flavor must be 'pt', 'tf' or 'auto' (got {cfg.model_flavor!r})"
        )
    for path in (cfg.checkpoint_path, cfg.pretrained_model):
        if path and os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a directory (a bts_tpu orbax checkpoint?): export it "
                "to a .pth first, ROADMAP.md queue 1, item 5"
            )
        if path and os.path.exists(path + ".index"):
            raise NotImplementedError(
                f"{path} is a TF checkpoint: TF flavor is ROADMAP.md queue 1, item 14"
            )
    normalization = "imagenet" if cfg.normalization == "auto" else cfg.normalization
    return cfg.replace(model_flavor="pt", normalization=normalization).validate()
