"""Configuration for the port: the ``Config`` dataclass and its flag surface.

A copy of ``bts_tpu/config.py``'s ``Config`` and argument parser, with the
same fields, flags and defaults, so reference and ``bts_tpu`` args files
carry over unchanged. ``model_flavor auto`` and ``normalization auto``
resolve as ``bts_tpu``'s do, by sniffing the checkpoints (cached per
instance): a full TF BTS checkpoint, or a port ``.pth`` whose decoder convs
carry biases, is the TF graph, with caffe normalization. ``parse_args``
checks what the port supports and pins both fields to their resolved values,
so nothing sniffs afterwards. An orbax directory is refused: export it with
``scripts/export_orbax_to_pth.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Config:
    """All experiment configuration. Field names mirror reference flags."""

    # Mode / identity
    mode: str = "train"
    model_name: str = "bts_eigen_v2"
    encoder: str = "densenet161_bts"

    # Dataset
    dataset: str = "nyu"  # 'nyu' | 'kitti'
    data_path: str = ""
    gt_path: str = ""
    filenames_file: str = ""
    input_height: int = 480
    input_width: int = 640
    max_depth: float = 10.0

    # Log and save
    log_directory: str = ""
    checkpoint_path: str = ""
    pretrained_model: str = ""
    log_freq: int = 100
    save_freq: int = 500
    max_to_keep: int = 200

    # Training
    fix_first_conv_blocks: bool = False
    fix_first_conv_block: bool = False
    bn_no_track_stats: bool = False
    weight_decay: float = 1e-2
    bts_size: int = 512
    retrain: bool = False
    adam_eps: float = 1e-6
    batch_size: int = 4
    num_epochs: int = 50
    learning_rate: float = 1e-4
    end_learning_rate: float = -1.0
    variance_focus: float = 0.85

    # Preprocessing
    do_random_rotate: bool = False
    degree: float = 2.5
    do_kb_crop: bool = False
    use_right: bool = False
    # 'imagenet' | 'caffe' | 'caffe_unscaled' | 'symmetric' | 'auto'
    normalization: str = "auto"

    # Multi-device
    num_threads: int = 1
    world_size: int = 1
    rank: int = 0
    dist_url: str = ""
    dist_backend: str = ""
    gpu: Optional[int] = None
    multiprocessing_distributed: bool = False

    # Online eval
    do_online_eval: bool = False
    data_path_eval: str = ""
    gt_path_eval: str = ""
    filenames_file_eval: str = ""
    min_depth_eval: float = 1e-3
    max_depth_eval: float = 80.0
    eigen_crop: bool = False
    garg_crop: bool = False
    eval_freq: int = 500
    eval_summary_directory: str = ""

    # Test / eval-script flags
    save_lpg: bool = False
    pred_path: str = ""
    min_depth: float = 1e-3
    focal: float = -1.0

    # Additions of bts_tpu (no reference equivalent); kept so its args
    # files parse. The port reads all but the TPU layout options
    # mesh_axis_name and fast_tail. remat, remat_policy and remat_scope
    # rematerialise as bts_tpu does (models/remat.py).
    # async_checkpoint writes checkpoints on a background thread from
    # pinned host copies (training/checkpoint.py, CheckpointWriter).
    num_devices: int = 0
    mesh_axis_name: str = "data"
    compute_dtype: str = "float32"
    eval_batch_size: int = 1
    device_eval: bool = True
    seed: int = 42
    lpg_impl: str = "auto"
    model_flavor: str = "auto"
    fast_tail: bool = True
    device_augment: bool = False
    adam_bf16_moments: bool = False
    remat: bool = False
    remat_policy: str = "conv"
    remat_scope: str = "encoder"
    preempt_checkpoint: bool = True
    async_checkpoint: bool = False
    profile_steps: int = 0
    profile_dir: str = "/tmp/bts_tpu_trace"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def depth_mask_min(self) -> float:
        """Training loss valid-depth threshold (NYU > 0.1, KITTI > 1.0)."""
        return 0.1 if self.dataset == "nyu" else 1.0

    @property
    def resolved_end_learning_rate(self) -> float:
        """Reference: pytorch/bts_main.py:423 (-1 means 0.1 * lr)."""
        if self.end_learning_rate != -1.0:
            return self.end_learning_rate
        return 0.1 * self.learning_rate

    @property
    def resolved_normalization(self) -> str:
        """'imagenet', 'caffe', 'caffe_unscaled' or 'symmetric' (RGB in
        [-1, 1], Marigold's). The TF reference scales by 0.017 only for
        densenet encoders, so 'caffe' on another encoder resolves to
        'caffe_unscaled'. 'auto' is caffe where the weights were trained on
        the TF pipeline's caffe statistics (tensorflow/bts_dataloader.py:148-153):
        a TF --pretrained_model, or the TF graph; else the statistics the
        encoder's model class names (``NORMALIZATION``: 'symmetric' for
        Marigold, 'imagenet' for the rest)."""
        if self.normalization in ("imagenet", "caffe_unscaled", "symmetric"):
            return self.normalization
        if self.normalization not in ("caffe", "auto"):
            raise ValueError(
                f"normalization must be 'imagenet', 'caffe', 'caffe_unscaled', 'symmetric' or "
                f"'auto' (got {self.normalization!r})"
            )
        caffe = "caffe" if self.encoder.startswith("densenet") else "caffe_unscaled"
        if self.normalization == "caffe":
            return caffe
        if self.pretrained_model:
            from bts_tpu_torch.models import convert_tf

            if convert_tf.is_tf_checkpoint(self.pretrained_model):
                return caffe
        if self.resolved_flavor == "tf":
            return caffe
        from bts_tpu_torch.models import input_normalization

        return input_normalization(self.encoder)

    @property
    def resolved_flavor(self) -> str:
        """'pt' or 'tf'; 'auto' sniffs --checkpoint_path and
        --pretrained_model for the TF graph's weights: a full TF BTS
        checkpoint (the TF zoo's bts_nyu_v2 / bts_eigen_v2), or a ``.pth``
        whose state dict holds ``decoder.get_depth.0.bias`` (a port run of
        the TF graph, or one exported from ``bts_tpu``'s). A TF checkpoint
        needs tensorflow to be read: without it this raises ImportError.

        The sniff reads the checkpoints, so its result is cached per
        instance; ``replace`` makes a new instance, which sniffs afresh."""
        if self.model_flavor in ("pt", "tf"):
            return self.model_flavor
        if self.model_flavor != "auto":
            raise ValueError(
                f"model_flavor must be 'pt', 'tf' or 'auto' (got {self.model_flavor!r})"
            )
        key = (self.checkpoint_path, self.pretrained_model)
        cached = self.__dict__.get("_resolved_flavor_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
        from bts_tpu_torch.models import convert_tf
        from bts_tpu_torch.training.checkpoint import pth_saved_tf_flavor

        flavor = "pt"
        for path in key:
            if not path:
                continue
            if convert_tf.is_tf_checkpoint(path):
                if convert_tf.is_full_tf_bts_checkpoint(path):
                    flavor = "tf"
                    break
            elif os.path.isfile(path) and pth_saved_tf_flavor(path):
                flavor = "tf"
                break
        self._resolved_flavor_cache = (key, flavor)
        return flavor

    def validate(self) -> "Config":
        """Reject typo'd enum flags at the CLI boundary."""
        if self.dataset not in ("nyu", "kitti"):
            raise ValueError(f"dataset must be 'nyu' or 'kitti' (got {self.dataset!r})")
        if self.remat_policy not in ("conv", "full"):
            raise ValueError(f"remat_policy must be 'conv' or 'full' (got {self.remat_policy!r})")
        if self.remat_scope not in ("encoder", "all"):
            raise ValueError(f"remat_scope must be 'encoder' or 'all' (got {self.remat_scope!r})")
        if self.lpg_impl not in ("auto", "xla", "pallas", "ffi"):
            raise ValueError(f"lpg_impl must be one of auto/xla/pallas/ffi (got {self.lpg_impl!r})")
        # These two raise on invalid values and cache their sniffs.
        _ = self.resolved_normalization
        _ = self.resolved_flavor
        return self


def _build_parser() -> argparse.ArgumentParser:
    """One flag per Config field; ``@argfile`` with whitespace-separated
    tokens, as the reference's args files are written."""
    parser = argparse.ArgumentParser(description="BTS-TPU", fromfile_prefix_chars="@")
    parser.convert_arg_line_to_args = lambda line: line.split()

    defaults = Config()
    for field in dataclasses.fields(Config):
        flag = "--" + field.name
        default = getattr(defaults, field.name)
        if field.type == "bool" or isinstance(default, bool):
            # Also --no-<name>, so default-True bools are controllable.
            parser.add_argument(flag, action=argparse.BooleanOptionalAction, default=default)
        elif field.name == "gpu":
            parser.add_argument(flag, type=int, default=None)
        else:
            ftype = type(default) if default is not None else str
            parser.add_argument(flag, type=ftype, default=default)
    return parser


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
    from bts_tpu_torch.models import check_encoder
    from bts_tpu_torch.ops.lpg import check_impl

    if cfg.dataset not in ("nyu", "kitti"):
        raise ValueError(f"dataset must be 'nyu' or 'kitti' (got {cfg.dataset!r})")
    from bts_tpu_torch.models import convert_tf

    check_impl(cfg.lpg_impl)
    check_encoder(cfg.encoder)
    for path in (cfg.checkpoint_path, cfg.pretrained_model):
        if path and os.path.isdir(path) and not convert_tf.is_tf_checkpoint(path):
            raise NotImplementedError(
                f"{path} is a directory (a bts_tpu orbax checkpoint?): the port reads "
                ".pth files and TF checkpoints; export it with python "
                f"scripts/export_orbax_to_pth.py {path} <out.pth>"
            )
    return cfg.replace(model_flavor=cfg.resolved_flavor,
                       normalization=cfg.resolved_normalization).validate()


def config_to_argfile(cfg: Config) -> str:
    """Serialize a Config back to reference-style args-file text (the
    non-default fields)."""
    lines: List[str] = []
    defaults = Config()
    for field in dataclasses.fields(Config):
        val = getattr(cfg, field.name)
        if val == getattr(defaults, field.name):
            continue
        if isinstance(val, bool):
            # val != default here, so non-default False means --no-<name>.
            lines.append(f"--{field.name}" if val else f"--no-{field.name}")
        else:
            lines.append(f"--{field.name} {val}")
    return "\n".join(lines) + "\n"
