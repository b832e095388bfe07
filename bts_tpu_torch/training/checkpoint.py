"""Checkpoints: ``bts_tpu/training/checkpoint.py`` in the reference's format.

A checkpoint is one ``torch.save`` file holding the reference PyTorch
trainer's dict (pytorch/bts_main.py:500-503,532-539): ``global_step``,
``model`` (the state dict), ``optimizer``, ``best_eval_measures_higher_better``,
``best_eval_measures_lower_better`` and ``best_eval_steps``. Names follow the
reference: ``model-{step}`` and ``model-{step}-best_{metric}_{value:.5f}``.

Restore (``restore_training_start``) takes the port's own files (a full
resume: weights, optimizer state, step, best tracker), the reference's
``.pth`` files, whose ``torch.optim.AdamW`` state has no counterpart here,
and TF checkpoints (the TF graph's weights and the stored global_step): for
the last two the optimizer starts fresh with its LR schedule advanced to the
restored step (``advance_schedule_count``). ``--retrain`` restarts the step
and the LR. An orbax directory is refused by ``config.parse_args``; export
it with ``scripts/export_orbax_to_pth.py``. ``average_checkpoints`` and
``save_params_only`` make an inference checkpoint of several
(``cli/avg_checkpoints.py``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from bts_tpu_torch.evaluation.metrics import EVAL_METRICS, NUM_HIGHER_BETTER, NUM_LOWER_BETTER
from bts_tpu_torch.models.convert import model_state
from bts_tpu_torch.training.optim import advance_schedule_count, is_port_optimizer_state

BEST_KEYS = ("best_eval_measures_lower_better", "best_eval_measures_higher_better",
             "best_eval_steps")

_STEP_RE = re.compile(r"model-(\d+)$")


class BestTracker:
    """Per-metric best values (6 lower-better + 3 higher-better) and steps."""

    def __init__(self):
        self.lower = np.zeros(NUM_LOWER_BETTER) + 1e3
        self.higher = np.zeros(NUM_HIGHER_BETTER)
        self.steps = np.zeros(len(EVAL_METRICS), dtype=np.int64)

    def update(self, measures: np.ndarray, step: int):
        """Returns a list of (metric_index, old_step, old_value) for new bests."""
        improved = []
        for i in range(len(EVAL_METRICS)):
            m = float(measures[i])
            if i < NUM_LOWER_BETTER:
                if m < self.lower[i]:
                    improved.append((i, int(self.steps[i]), float(self.lower[i])))
                    self.lower[i] = m
                    self.steps[i] = step
            else:
                j = i - NUM_LOWER_BETTER
                if m > self.higher[j]:
                    improved.append((i, int(self.steps[i]), float(self.higher[j])))
                    self.higher[j] = m
                    self.steps[i] = step
        return improved

    def to_dict(self) -> Dict[str, torch.Tensor]:
        """The reference's three entries, as tensors."""
        return {
            "best_eval_measures_lower_better": torch.from_numpy(np.array(self.lower)),
            "best_eval_measures_higher_better": torch.from_numpy(np.array(self.higher)),
            "best_eval_steps": torch.from_numpy(np.array(self.steps)),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BestTracker":
        t = cls()
        t.lower = np.array(d["best_eval_measures_lower_better"], dtype=np.float64)
        t.higher = np.array(d["best_eval_measures_higher_better"], dtype=np.float64)
        t.steps = np.array(d["best_eval_steps"], dtype=np.int64)
        return t


def save_checkpoint(path: str, state, best: Optional[BestTracker] = None) -> None:
    """Write the reference trainer's dict to ``path`` (a file), atomically."""
    payload = {
        "global_step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        **(best or BestTracker()).to_dict(),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _numpy_globals():
    """What unpickling a numpy array needs (the reference trainer saves
    best_eval_steps as one), under numpy 2's and numpy 1's module names."""
    try:
        from numpy._core.multiarray import _reconstruct
    except ImportError:  # numpy 1
        from numpy.core.multiarray import _reconstruct
    return [
        _reconstruct, (_reconstruct, "numpy.core.multiarray._reconstruct"),
        (_reconstruct, "numpy._core.multiarray._reconstruct"), np.ndarray, np.dtype,
        *(type(np.dtype(t)) for t in (np.int32, np.int64, np.float32, np.float64)),
    ]


def load_checkpoint_dict(path: str) -> Dict[str, Any]:
    """Read a checkpoint file on the CPU: the port's or a reference trainer's
    (whose best_eval_steps may be a numpy array), or a bare state dict. Its
    ``model`` is the model's state dict (``convert.model_state``: no DDP
    prefix, no reference-only keys)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"No checkpoint at '{path}'. Expected a .pth file saved by this port "
            "(<log_directory>/<model_name>/model-<step>) or by the reference trainer."
        )
    with torch.serialization.safe_globals(_numpy_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and "model" in ckpt):
        ckpt = {"model": ckpt}
    ckpt["model"] = model_state(ckpt["model"])
    return ckpt


TF_GRAPH_KEY = "decoder.get_depth.0.bias"  # only the TF graph's decoder convs have biases


def pth_saved_tf_flavor(path: str) -> bool:
    """True when the ``.pth`` at ``path`` holds the TF graph's weights: its
    state dict has ``decoder.get_depth.0.bias`` (``bts_tpu``'s
    ``orbax_saved_tf_flavor`` sniffs the same bias)."""
    return TF_GRAPH_KEY in load_checkpoint_dict(path)["model"]


def average_checkpoints(paths) -> Dict[str, torch.Tensor]:
    """Uniform average of the model state of N checkpoint files (port or
    reference ``.pth``): ``bts_tpu``'s ``average_checkpoints``. Float
    tensors are summed in float64, divided by N and cast back to their
    dtype; the others (``num_batches_tracked``) keep the first file's value.
    BN running statistics are averaged too, the usual cheap stand-in for
    re-estimating them with a pass over data."""
    if not paths:
        raise ValueError("average_checkpoints: need at least one path")
    first = load_checkpoint_dict(paths[0])["model"]
    acc = {k: v.double() for k, v in first.items() if v.is_floating_point()}
    for path in paths[1:]:
        state = load_checkpoint_dict(path)["model"]
        if state.keys() != first.keys():
            raise ValueError(f"{path}: its tensors differ by name from {paths[0]}'s")
        for k in acc:
            acc[k] += state[k].double()
    n = float(len(paths))
    return {k: (acc[k] / n).to(v.dtype) if k in acc else v for k, v in first.items()}


def save_params_only(path: str, state: Dict[str, torch.Tensor]) -> None:
    """An inference checkpoint: the reference's dict with only its ``model``
    key, written atomically; ``cli.test`` and ``--checkpoint_path`` read it."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state}, tmp)
    os.replace(tmp, path)


def restore_training_start(cfg, state, best: BestTracker):
    """Apply ``--checkpoint_path`` (and ``--retrain``) to a fresh train state.
    Returns (state, best).

    * a file saved by this port: full resume (weights, optimizer state,
      step, best tracker; the reference's resume, pytorch/bts_main.py:376-397);
    * a reference torch file (trainer save, zoo release or bare state dict):
      the weights, plus global_step and the best tracker where the dict
      carries them; the optimizer's moments start fresh and its LR schedule
      is advanced to the restored step;
    * a TF checkpoint (prefix or directory): its weights converted strictly
      onto the TF graph, and global_step where it is stored; a fresh
      optimizer, as for a reference file.
    """
    from bts_tpu_torch.models import convert_tf

    if cfg.checkpoint_path and convert_tf.is_tf_checkpoint(cfg.checkpoint_path):
        converted, meta = convert_tf.load_full_tf(cfg.checkpoint_path, state.model.state_dict(),
                                                  cfg.encoder, cfg.bts_size)
        state.model.load_state_dict(converted, strict=True)
        state.step = meta.get("global_step", 0)
        advance_schedule_count(state.optimizer, state.step)
        print(f"Loaded TF checkpoint '{cfg.checkpoint_path}' (global_step {state.step}; "
              "fresh optimizer moments)")
    elif cfg.checkpoint_path:
        ckpt = load_checkpoint_dict(cfg.checkpoint_path)
        state.model.load_state_dict(ckpt["model"], strict=True)
        step = int(ckpt.get("global_step", 0))
        state.step = step
        if all(k in ckpt for k in BEST_KEYS):
            best = BestTracker.from_dict(ckpt)
        if is_port_optimizer_state(ckpt.get("optimizer")):
            state.optimizer.load_state_dict(ckpt["optimizer"])
            print(f"Loaded checkpoint '{cfg.checkpoint_path}' (global_step {step})")
        else:
            advance_schedule_count(state.optimizer, step)
            print(f"Loaded weights from '{cfg.checkpoint_path}' "
                  f"(global_step {step}; fresh optimizer moments)")
    if cfg.retrain:
        # --retrain restarts from step zero (pytorch/bts_main.py:399-400), and
        # the LR schedule with it.
        state.step = 0
        advance_schedule_count(state.optimizer, 0)
    return state, best


def best_checkpoint_name(step: int, metric: str, value: float) -> str:
    """Reference naming (pytorch/bts_main.py:530)."""
    return f"model-{step}-best_{metric}_{value:.5f}"


def remove_old_best(log_dir: str, step: int, metric: str, value: float) -> None:
    """Delete a superseded best checkpoint (pytorch/bts_main.py:524-528)."""
    path = os.path.join(log_dir, best_checkpoint_name(step, metric, value))
    if os.path.exists(path):
        os.remove(path)


def list_step_checkpoints(log_dir: str) -> Dict[int, str]:
    """The 'model-{step}' checkpoints in ``log_dir`` (pytorch/bts_eval.py:120-137)."""
    out: Dict[int, str] = {}
    if not os.path.isdir(log_dir):
        return out
    for name in os.listdir(log_dir):
        m = _STEP_RE.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(log_dir, name)
    return out


def prune_step_checkpoints(log_dir: str, max_to_keep: int) -> None:
    """Keep only the newest ``max_to_keep`` 'model-{step}' checkpoints
    (tf.train.Saver(max_to_keep), tensorflow/bts_main.py:214). Best-metric
    checkpoints are never pruned."""
    if max_to_keep <= 0:
        return
    ckpts = list_step_checkpoints(log_dir)
    for step in sorted(ckpts)[:-max_to_keep]:
        os.remove(ckpts[step])
