"""The training driver: ``bts_tpu/training/loop.py`` in PyTorch.

Reference behaviours (pytorch/bts_main.py:322-604):
  * the model, seeded, and ``--pretrained_model`` warm start by name
    intersection;
  * AdamW param groups with set_misc freezing (``training/optim.py``);
  * checkpoint restore and ``--retrain`` (``training/checkpoint.py``);
  * a per-epoch reshuffle (``TrainLoader.epoch``);
  * console lines with loss, LR, examples/s, the parameters' mean sum and
    the time left (pytorch/bts_main.py:462-480), and the NaN abort
    (:464-466): ``train`` returns -1;
  * TensorBoard scalars and image panels (:482-496), with tensorboardX when
    it imports;
  * periodic ``model-{step}`` checkpoints (:498-503), pruned to
    ``max_to_keep``.

The loop reads each step's loss back three steps late, so the host does not
wait for the card every step. ``--do_online_eval`` (ROADMAP.md queue 1,
item 11) and more than one device (item 10) are not ported yet.
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
from bts_tpu_torch.data.loader import TrainLoader
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
    """TensorBoard scalars and image panels, when tensorboardX imports."""

    def __init__(self, cfg: Config, run_dir: str):
        self.cfg = cfg
        self.writer = None
        if run_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(os.path.join(run_dir, "summaries"), flush_secs=30)

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

    def close(self):
        if self.writer is not None:
            self.writer.close()


def param_sum_avg(model: torch.nn.Module) -> float:
    """Mean over parameter tensors of each one's sum (the reference's 'var
    avg'), with one readback."""
    params = list(model.parameters())
    total = torch.stack([p.detach().float().sum() for p in params]).sum()
    return float(total) / max(len(params), 1)


def warm_start(model: torch.nn.Module, path: str) -> None:
    """Load the tensors of a torch .pth whose names and shapes match the
    model's (the reference's --pretrained_model, tensorflow/bts_main.py:228-232)."""
    from bts_tpu_torch.models.convert import load_checkpoint

    own = model.state_dict()
    state = {k: v for k, v in load_checkpoint(path).items()
             if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(state, strict=False)


def train(cfg: Config, max_steps: Optional[int] = None,
          device: Optional[torch.device] = None) -> int:
    """Run training on ``device`` (default the CUDA card). Returns the final
    global step, or -1 on a NaN loss (pytorch/bts_main.py:464-466)."""
    if cfg.do_online_eval:
        raise NotImplementedError(
            "--do_online_eval needs the evaluation modules, not ported yet: "
            "ROADMAP.md queue 1, item 11"
        )
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
        warm_start(model, cfg.pretrained_model)
        print(f"Warm-started from '{cfg.pretrained_model}'")
    model.to(device)

    loader = TrainLoader(cfg)
    steps_per_epoch = loader.steps_per_epoch()
    num_total_steps = cfg.num_epochs * steps_per_epoch
    optimizer, _ = create_optimizer(cfg, model, num_total_steps)
    state, best = ckpt_lib.restore_training_start(
        cfg, TrainState(model, optimizer), ckpt_lib.BestTracker())
    train_step = make_train_step(cfg)
    logger = TrainLogger(cfg, run_dir)
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

                if global_step % cfg.save_freq == 0 and run_dir:
                    # Flush the delayed readbacks first so logs stay in step order.
                    if not drain():
                        return finish(-1)
                    ckpt_lib.save_checkpoint(os.path.join(run_dir, f"model-{global_step}"),
                                             state, best)
                    ckpt_lib.prune_step_checkpoints(run_dir, cfg.max_to_keep)

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
