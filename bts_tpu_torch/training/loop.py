"""The training driver: ``bts_tpu/training/loop.py`` in PyTorch.

Reference behaviours (pytorch/bts_main.py:322-604):
  * the model, seeded, and ``--pretrained_model`` warm start by name
    intersection (a ``.pth``, or a TF encoder checkpoint); a full TF BTS
    checkpoint loads strictly into the TF graph;
  * AdamW param groups with set_misc freezing (``training/optim.py``);
  * checkpoint restore and ``--retrain`` (``training/checkpoint.py``);
  * a per-epoch reshuffle (``TrainLoader.epoch``);
  * console lines with loss, LR, examples/s, the parameters' mean sum and
    the time left (pytorch/bts_main.py:462-480), and the NaN abort
    (:464-466): ``train`` returns -1;
  * TensorBoard scalars and image panels (:482-496), with tensorboardX when
    it imports;
  * periodic ``model-{step}`` checkpoints (:498-503), pruned to
    ``max_to_keep``;
  * under ``--do_online_eval``, an eval every ``eval_freq`` steps (:505-545)
    in place of the periodic saves: the nine measures to the console and
    TensorBoard, and a ``model-{step}-best_{metric}_{value:.5f}`` checkpoint
    for each metric that improved, its previous best deleted.

The loop reads each step's loss back three steps late, so the host does not
wait for the card every step. More than one device (ROADMAP.md queue 1,
item 10) is not ported yet.
"""

from __future__ import annotations

import os
import signal
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from bts_tpu_torch.config import Config
from bts_tpu_torch.data.loader import EvalLoader, TrainLoader
from bts_tpu_torch.evaluation.metrics import EVAL_METRICS
from bts_tpu_torch.evaluation.offline import eval_summary_writer
from bts_tpu_torch.evaluation.online import make_eval_forward, run_online_eval
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.training import checkpoint as ckpt_lib
from bts_tpu_torch.training.lr import polynomial_decay_host
from bts_tpu_torch.training.optim import create_optimizer
from bts_tpu_torch.training.preempt import PreemptionGuard
from bts_tpu_torch.training.snapshot import snapshot_run
from bts_tpu_torch.training.state import (
    TrainState,
    make_panel_forward,
    make_train_step,
    to_device,
)

PIPELINE_DEPTH = 3  # steps between a step's launch and its loss's readback
PROFILE_START_STEP = 10


class TrainLogger:
    """TensorBoard scalars and image panels, and the eval scalars under
    ``--do_online_eval``, when tensorboardX imports."""

    def __init__(self, cfg: Config, run_dir: str):
        self.cfg = cfg
        self.writer = None
        self.eval_writer = None
        if run_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(os.path.join(run_dir, "summaries"), flush_secs=30)
            if cfg.do_online_eval:
                self.eval_writer = eval_summary_writer(cfg)

    def scalars(self, step: int, loss: float, lr: float, var_avg: float):
        if self.writer is not None:
            self.writer.add_scalar("silog_loss", loss, step)
            self.writer.add_scalar("learning_rate", lr, step)
            self.writer.add_scalar("var average", var_avg, step)
            self.writer.flush()

    def images(self, step: int, image: np.ndarray, depth_gt: np.ndarray, outs):
        """Inverse-depth panels (pytorch/bts_main.py:487-495): image (B,H,W,3)
        normalized, depth_gt (B,H,W,1), outs the model's five (B,1,H,W)."""
        from bts_tpu_torch.data.transforms import denormalize_image
        from bts_tpu_torch.utils.colorize import normalize_result

        lpg8, lpg4, lpg2, reduc1, depth_est = outs
        depth_gt = np.where(depth_gt < 1e-3, 1e3, depth_gt)
        for i in range(min(self.cfg.batch_size, depth_gt.shape[0])):
            w = self.writer
            w.add_image(f"depth_gt/image/{i}", normalize_result(1.0 / depth_gt[i]), step)
            w.add_image(f"depth_est/image/{i}", normalize_result(1.0 / depth_est[i]), step)
            w.add_image(f"reduc1x1/image/{i}",
                        normalize_result(1.0 / np.maximum(reduc1[i], 1e-6)), step)
            for name, arr in (("lpg2x2", lpg2), ("lpg4x4", lpg4), ("lpg8x8", lpg8)):
                w.add_image(f"{name}/image/{i}",
                            normalize_result(1.0 / np.maximum(arr[i], 1e-6)), step)
            img = denormalize_image(image[i], self.cfg.resolved_normalization)
            w.add_image(f"image/image/{i}", np.clip(img, 0, 1).transpose(2, 0, 1), step)
        self.writer.flush()

    def eval_scalars(self, step: int, measures: np.ndarray):
        if self.eval_writer is not None:
            for i, name in enumerate(EVAL_METRICS):
                self.eval_writer.add_scalar(name, float(measures[i]), step)
            self.eval_writer.flush()

    def close(self):
        for w in (self.writer, self.eval_writer):
            if w is not None:
                w.close()


def param_sum_avg(model: torch.nn.Module) -> float:
    """Mean over parameter tensors of each one's sum (the reference's 'var
    avg'), with one readback."""
    params = list(model.parameters())
    total = torch.stack([p.detach().float().sum() for p in params]).sum()
    return float(total) / max(len(params), 1)


def warm_start(model: torch.nn.Module, path: str, cfg: Optional[Config] = None) -> None:
    """``--pretrained_model`` (tensorflow/bts_main.py:228-232): a TF
    checkpoint holding the decoder (``decoder/Conv/``) loads strictly
    (``convert_tf.convert_full_tf``); any other TF checkpoint warm-starts the
    encoder by name (``warm_start_from_tf``); both read ``cfg``'s encoder and
    bts_size. A torch .pth loads the tensors whose names and shapes match the
    model's."""
    from bts_tpu_torch.models import convert_tf
    from bts_tpu_torch.models.convert import load_checkpoint

    own = model.state_dict()
    if convert_tf.is_tf_checkpoint(path):
        if cfg is None:
            raise ValueError(f"warm start from the TF checkpoint {path} needs the config")
        tf_vars = convert_tf.load_tf_checkpoint(convert_tf.tf_latest_checkpoint(path) or path)
        if any("decoder/Conv/" in n for n in tf_vars):
            state, report = convert_tf.convert_full_tf(tf_vars, own, cfg.encoder, cfg.bts_size)
            model.load_state_dict(state, strict=True)
            print(f"Loaded full TF BTS checkpoint '{path}' ({len(report['loaded'])} tensors)")
            return
        state, report = convert_tf.warm_start_from_tf(tf_vars, own, cfg.encoder)
        model.load_state_dict(state, strict=True)
        for name in report["unmatched_checkpoint"]:
            # The reference's wording, tensorflow/bts_main.py:119.
            print(f"{name} is in pretrained model but not in current training model")
        print(f"Warm-started {len(report['loaded'])} tensors from TF checkpoint '{path}'")
        return
    state = {k: v for k, v in load_checkpoint(path).items()
             if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(state, strict=False)
    print(f"Warm-started from '{path}'")


def train(cfg: Config, max_steps: Optional[int] = None,
          device: Optional[torch.device] = None) -> int:
    """Run training on ``device`` (default the CUDA card). Returns the final
    global step, or -1 on a NaN loss (pytorch/bts_main.py:464-466)."""
    if cfg.num_devices > 1:
        raise NotImplementedError(
            f"num_devices {cfg.num_devices}: data parallelism is not ported yet: "
            "ROADMAP.md queue 1, item 10"
        )
    device = torch.device(device or "cuda")
    run_dir = snapshot_run(cfg) if cfg.log_directory else ""

    model = create_model(cfg)
    print(f"Total number of parameters: {sum(p.numel() for p in model.parameters())}")
    if cfg.pretrained_model:
        warm_start(model, cfg.pretrained_model, cfg)
    model.to(device)

    loader = TrainLoader(cfg)
    steps_per_epoch = loader.steps_per_epoch()
    num_total_steps = cfg.num_epochs * steps_per_epoch
    optimizer, _ = create_optimizer(cfg, model, num_total_steps)
    state, best = ckpt_lib.restore_training_start(
        cfg, TrainState(model, optimizer), ckpt_lib.BestTracker())
    train_step = make_train_step(cfg)
    logger = TrainLogger(cfg, run_dir)
    eval_loader = EvalLoader(cfg, "online_eval") if cfg.do_online_eval else None
    eval_forward = make_eval_forward(model, cfg) if cfg.do_online_eval else None
    host_lr = polynomial_decay_host(cfg.learning_rate, cfg.resolved_end_learning_rate,
                                    num_total_steps, power=0.9)

    global_step = state.step
    epoch = global_step // max(steps_per_epoch, 1)
    start_time = time.time()
    duration = 0.0
    model_just_loaded = bool(cfg.checkpoint_path)
    profiler = None
    pending = deque()  # steps whose loss has not been read back yet
    panel_forward = None

    def process_pending(p) -> bool:
        """Read back and log step p. False on a NaN loss (abort)."""
        nonlocal panel_forward
        loss = float(p["loss"])
        print(f"[epoch][s/s_per_e/gs]: [{p['epoch']}][{p['sie']}/{steps_per_epoch}/{p['gs']}], "
              f"lr: {p['lr']:.12f}, loss: {loss:.12f}")
        if np.isnan(loss):
            print("NaN in loss occurred. Aborting training.")
            return False
        if p["log"]:
            var_avg = param_sum_avg(state.model)
            examples_per_sec = (cfg.batch_size / p["duration"] * cfg.log_freq
                                if p["duration"] else 0.0)
            time_sofar = (time.time() - start_time) / 3600
            training_time_left = (num_total_steps / max(p["gs"], 1) - 1.0) * time_sofar
            print(cfg.model_name)
            print(f"examples/s: {examples_per_sec:4.2f} | loss: {loss:.5f} | var avg: "
                  f"{var_avg:.3f} | time elapsed: {time_sofar:.2f}h | time left: "
                  f"{training_time_left:.2f}h")
            logger.scalars(p["gs"], loss, p["lr"], var_avg)
            if logger.writer is not None and p["device_batch"] is not None:
                if panel_forward is None:
                    panel_forward = make_panel_forward(state.model, cfg)
                outs, img, dpt = panel_forward(p["device_batch"], p["gs"] - 1)
                logger.images(p["gs"], img.cpu().numpy(), dpt.cpu().numpy(),
                              [o.cpu().numpy() for o in outs])
        return True

    def drain() -> bool:
        while pending:
            if not process_pending(pending.popleft()):
                return False
        return True

    def evaluate(step: int) -> None:
        """Online eval at ``step``: the measures logged, and a best
        checkpoint for each metric that improved (pytorch/bts_main.py:505-545)."""
        measures = run_online_eval(state.model, cfg, eval_loader, eval_forward)
        logger.eval_scalars(step, measures)
        for mi, old_step, old_value in best.update(measures, step):
            if not run_dir:
                continue
            metric = EVAL_METRICS[mi]
            ckpt_lib.remove_old_best(run_dir, old_step, metric, old_value)
            name = ckpt_lib.best_checkpoint_name(step, metric, float(measures[mi]))
            print(f"New best for {metric}. Saving model: {name}")
            ckpt_lib.save_checkpoint(os.path.join(run_dir, name), state, best)

    # Checkpoint and exit cleanly at the next step boundary on SIGTERM.
    preempt_guard = PreemptionGuard(signals=(signal.SIGTERM,) if cfg.preempt_checkpoint else ())
    preempt_guard.__enter__()

    def finish(rv: int) -> int:
        if profiler is not None:
            profiler.stop()
        preempt_guard.__exit__(None, None, None)
        logger.close()
        return rv

    try:
        while epoch < cfg.num_epochs:
            for batch in loader.epoch(epoch):
                if cfg.profile_steps:
                    if global_step == PROFILE_START_STEP and profiler is None:
                        profiler = start_profiler(cfg.profile_dir, device)
                    elif profiler is not None and global_step >= (
                            PROFILE_START_STEP + cfg.profile_steps):
                        profiler.stop()
                        profiler = None
                        print(f"Profiler trace written to {cfg.profile_dir}")
                t0 = time.time()
                device_batch = to_device(batch, device)
                loss = train_step(state, device_batch)
                global_step += 1

                will_log = global_step % cfg.log_freq == 0 and not model_just_loaded
                this_step = {
                    "gs": global_step,
                    "epoch": epoch,
                    "sie": (global_step - 1) % steps_per_epoch,
                    "lr": host_lr(global_step),
                    "loss": loss,
                    "log": will_log,
                    # Kept only when panels will be drawn; they are drawn with
                    # the weights of the step that reads them back.
                    "device_batch": device_batch if will_log else None,
                    "duration": 0.0,
                }
                pending.append(this_step)
                pipeline_ok = len(pending) <= PIPELINE_DEPTH or process_pending(pending.popleft())
                # Wall time after the delayed readback, so the logged
                # examples/s is the steps' real rate and not their dispatch.
                duration += time.time() - t0
                if will_log:
                    this_step["duration"] = duration
                    duration = 0.0
                if not pipeline_ok:
                    return finish(-1)

                will_save = (not cfg.do_online_eval and global_step % cfg.save_freq == 0
                             and run_dir)
                will_eval = (cfg.do_online_eval and global_step % cfg.eval_freq == 0
                             and not model_just_loaded)
                # Flush the delayed readbacks first so logs stay in step order.
                if (will_save or will_eval) and not drain():
                    return finish(-1)
                if will_save:
                    ckpt_lib.save_checkpoint(os.path.join(run_dir, f"model-{global_step}"),
                                             state, best)
                    ckpt_lib.prune_step_checkpoints(run_dir, cfg.max_to_keep)
                if will_eval:
                    evaluate(global_step)

                model_just_loaded = False
                if preempt_guard.requested:
                    if not drain():
                        return finish(-1)
                    if run_dir:
                        print("Termination signal received; saving checkpoint "
                              f"model-{global_step} and exiting cleanly.")
                        ckpt_lib.save_checkpoint(
                            os.path.join(run_dir, f"model-{global_step}"), state, best)
                    return finish(global_step)
                if max_steps is not None and global_step >= max_steps:
                    return finish(global_step if drain() else -1)
            epoch += 1
        return finish(global_step if drain() else -1)
    finally:
        # Always restore the SIGTERM handler, also when the loop raises.
        preempt_guard.__exit__(None, None, None)


def start_profiler(profile_dir: str, device: torch.device):
    """A torch.profiler session (CPU, and CUDA on a card) that writes a
    Chrome trace into ``profile_dir`` when stopped."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])

    def export(prof):
        prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{os.getpid()}.json"))

    prof = profile(activities=activities, on_trace_ready=export)
    prof.start()
    return prof
