"""Checkpoints: ``bts_tpu/training/checkpoint.py`` in the reference's format.

A checkpoint is one ``torch.save`` file holding the reference PyTorch
trainer's dict (pytorch/bts_main.py:500-503,532-539): ``global_step``,
``model`` (the state dict), ``optimizer``, ``best_eval_measures_higher_better``,
``best_eval_measures_lower_better`` and ``best_eval_steps``. Names follow the
reference: ``model-{step}`` and ``model-{step}-best_{metric}_{value:.5f}``.

Saves run on the loop's thread or, with ``async_save``
(``--async_checkpoint``), on a background writer (``CheckpointWriter``)
with ``bts_tpu``'s semantics: at most one save in flight, drained before
every removal (``remove_old_best``, ``prune_step_checkpoints``), before
``save_params_only`` and at the loop's end (``wait_for_async_saves``).

Restore (``restore_training_start``) takes the port's own files and the
exports of ``bts_tpu`` runs (``scripts/export_orbax_to_pth.py``, optax's
moments and counts included): a full resume of weights, optimizer state,
step and best tracker. It also takes the reference's ``.pth`` files, whose
``torch.optim.AdamW`` state has no counterpart here, and TF checkpoints
(the TF graph's weights and the stored global_step): for those two the
optimizer starts fresh with its LR schedule advanced to the restored step
(``advance_schedule_count``), as in ``bts_tpu``. ``--retrain`` restarts the
step and the LR. An orbax directory is refused by ``config.parse_args``.
``average_checkpoints`` and ``save_params_only`` make an inference
checkpoint of several (``cli/avg_checkpoints.py``).
"""

from __future__ import annotations

import os
import re
import threading
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


class CheckpointWriter:
    """Writes checkpoint dicts with ``torch.save``, on this thread or on a
    background one, at most one save in flight (``bts_tpu``'s orbax
    ``AsyncCheckpointer``, ``bts_tpu/training/checkpoint.py:90-143``).

    A save first waits for the one in flight. Then it copies every tensor of
    the payload into host buffers of its own, which it keeps from save to
    save (pinned for a card's tensors): the copies are enqueued on the
    current stream and an event is recorded after them. ``AdamW.step`` and
    the BN statistics change the live tensors in place, but the next step's
    kernels run on the same stream after the copies, so the buffers hold the
    state as it was at the save. The writer then waits on the event and
    writes the buffers to a temporary file that replaces ``path``. On CPU
    tensors the copies are synchronous. An exception of a background write
    is raised by the next ``wait`` (or save)."""

    def __init__(self):
        self._buffers: Dict[str, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        """Block until the save in flight, if any, has replaced its file;
        raise its exception if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def save(self, path: str, payload: Dict[str, Any], async_save: bool = False) -> None:
        """Write ``payload`` to ``path``; with ``async_save`` on a background
        thread, returning once the copies to the host are enqueued."""
        self.wait()
        buffers: Dict[str, torch.Tensor] = {}
        cards = set()
        host = self._to_host(payload, "", buffers, cards)
        self._buffers = buffers  # a buffer no tensor of this payload uses is freed
        events = []  # after the copies, on each card's current stream
        for device in cards:
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(device))
        if not async_save:
            _write(path, host, events)
            return
        self._thread = threading.Thread(target=self._run, args=(path, host, events),
                                        name="checkpoint-writer")
        self._thread.start()

    def _run(self, path: str, host: Dict[str, Any], events) -> None:
        try:
            _write(path, host, events)
        except Exception as e:  # raised on the caller's thread by wait()
            self._error = e

    def _to_host(self, obj, key: str, buffers: Dict[str, torch.Tensor], cards: set):
        """``obj`` with each tensor replaced by its host buffer (``buffers``,
        by ``key``, the tensor's place in the payload), its copy enqueued;
        ``cards`` collects the devices copied from."""
        if isinstance(obj, torch.Tensor):
            t = obj.detach()
            buf = self._buffers.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                cards.add(t.device)
            buffers[key] = buf
            return buf
        if isinstance(obj, dict):
            return {k: self._to_host(v, f"{key}/{k}", buffers, cards) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._to_host(v, f"{key}/{i}", buffers, cards)
                             for i, v in enumerate(obj))
        return obj


def _write(path: str, payload: Dict[str, Any], events=()) -> None:
    """``torch.save`` to a temporary file that then replaces ``path``, once
    ``events`` (after the copies into ``payload``'s buffers) have completed."""
    for event in events:
        event.synchronize()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


_WRITER = CheckpointWriter()


def wait_for_async_saves() -> None:
    """Block until the checkpoint save in flight has committed; re-raise its
    exception if it failed."""
    _WRITER.wait()


def checkpoint_payload(state, best: Optional[BestTracker] = None) -> Dict[str, Any]:
    """The reference trainer's dict of ``state``; its tensors are the live
    ones (``CheckpointWriter.save`` copies them)."""
    return {
        "global_step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        **(best or BestTracker()).to_dict(),
    }


def save_checkpoint(path: str, state, best: Optional[BestTracker] = None,
                    async_save: bool = False) -> None:
    """Write the reference trainer's dict to ``path`` (a file), atomically.

    ``async_save`` returns once the state's copies to the host are enqueued;
    a background thread writes the file (``CheckpointWriter``). At most one
    save is in flight: any save first waits for the previous one. Call
    ``wait_for_async_saves()`` before reading the file back or exiting."""
    _WRITER.save(path, checkpoint_payload(state, best), async_save)


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
    wait_for_async_saves()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state}, tmp)
    os.replace(tmp, path)


def restore_training_start(cfg, state, best: BestTracker):
    """Apply ``--checkpoint_path`` (and ``--retrain``) to a fresh train state.
    Returns (state, best).

    * a file saved by this port, or a bts_tpu run exported by
      ``scripts/export_orbax_to_pth.py``: full resume (weights, optimizer
      state with its moments and counts, step, best tracker; the
      reference's resume, pytorch/bts_main.py:376-397, and bts_tpu's,
      bts_tpu/training/loop.py:144-181);
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
    """Delete a superseded best checkpoint (pytorch/bts_main.py:524-528),
    once the save in flight has committed."""
    wait_for_async_saves()
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
    checkpoints are never pruned. Waits for the save in flight first, so
    that it is counted."""
    wait_for_async_saves()
    if max_to_keep <= 0:
        return
    ckpts = list_step_checkpoints(log_dir)
    for step in sorted(ckpts)[:-max_to_keep]:
        os.remove(ckpts[step])
