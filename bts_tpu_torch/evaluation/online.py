"""Online (in-training) evaluation: ``bts_tpu/evaluation/online.py`` in PyTorch.

Reference: pytorch/bts_main.py:250-319 -- run the eval split, accumulate the
nine metric sums and a sample count, all-reduce across ranks, print the
table. Here:
  * the forward runs batched (cfg.eval_batch_size) on the card, in eval mode
    under ``torch.no_grad`` and bf16 autocast when ``--compute_dtype
    bfloat16`` (so the fused dense-layer and LPG kernels serve it), and
    leaves the model in the modes it had;
  * with ``--device_eval`` (the default) the metrics run on the card
    (``evaluation/device_eval.py``); else each sample goes through the numpy
    protocol (``evaluation/protocol.py``), bit-matching the reference;
  * under data parallelism each rank evaluates its exact-count shard
    (``EvalLoader``: rank r takes samples r::world), and the ranks' sums and
    counts are all-gathered and added (the reference's all_reduce,
    pytorch/bts_main.py:302-304); only rank 0 returns and prints them.
    ``process_info`` and ``allgather_fn`` are injectable, so the
    cross-process sum can also be simulated in one process.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from bts_tpu_torch.apps.predict import compute_context, forward_padded
from bts_tpu_torch.config import Config
from bts_tpu_torch.data.loader import EvalLoader
from bts_tpu_torch.evaluation.metrics import EVAL_METRICS, compute_errors
from bts_tpu_torch.evaluation.protocol import prepare_pred_gt
from bts_tpu_torch.parallel.mesh import process_shard_info


def allgather_vector(vec: np.ndarray, group=None) -> np.ndarray:
    """(10,) on each rank of ``group`` (the default group when None) ->
    (world, 10) f32, in rank order. On the card under NCCL, on the host
    under gloo."""
    backend = dist.get_backend(group)
    device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    t = torch.as_tensor(np.asarray(vec, np.float32), device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).cpu().numpy()


def make_eval_forward(model: torch.nn.Module, cfg: Config) -> Callable:
    """fn(image (B,H,W,3) numpy, focal (B,) numpy) -> final depth (B,H,W) f32
    on the model's device. Inputs whose H or W is not a multiple of the
    encoder stride (32) are edge-padded and the output cropped back. Every
    module's train/eval mode is restored afterwards (under
    ``--bn_no_track_stats`` the train step keeps its BN modules in eval).
    The compute context is ``apps/predict.py``'s, as serving uses."""
    def forward(image: np.ndarray, focal: np.ndarray) -> torch.Tensor:
        device = next(model.parameters()).device
        modes = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            with torch.no_grad(), compute_context(cfg, device):
                x = torch.from_numpy(np.ascontiguousarray(image)).permute(0, 3, 1, 2).to(device)
                f = torch.from_numpy(np.asarray(focal, np.float32)).to(device)
                depth = forward_padded(model, x, f)[-1][:, 0]
        finally:
            for m, training in modes:
                m.training = training
        return depth.float()

    return forward


def run_online_eval(
    model: Optional[torch.nn.Module],
    cfg: Config,
    loader: Optional[EvalLoader] = None,
    forward: Optional[Callable] = None,
    verbose: bool = True,
    process_info: Optional[tuple] = None,
    allgather_fn: Optional[Callable] = None,
) -> Optional[np.ndarray]:
    """The 9 mean metrics over the eval split (None on a non-primary process).

    ``forward`` (default ``make_eval_forward(model, cfg)``) maps a batch's
    (image, focal) to depth (B,H,W), a tensor or an array. ``process_info``
    = (nproc, pidx) defaults to the process group's (``process_shard_info``),
    and ``allgather_fn`` (vec (10,) f32 -> (nproc, 10)) to
    ``allgather_vector`` over it; injected, they simulate the cross-process
    sum in one process.
    """
    nproc, pidx = process_info if process_info is not None else process_shard_info()
    if nproc > 1 and allgather_fn is None:
        allgather_fn = allgather_vector
    if loader is None:
        loader = EvalLoader(cfg, "online_eval", num_shards=nproc, shard_index=pidx)
    if forward is None:
        forward = make_eval_forward(model, cfg)

    use_device = bool(cfg.device_eval)
    if use_device:
        from bts_tpu_torch.evaluation.device_eval import make_batch_metrics, run_batch

        batch_metrics = make_batch_metrics(cfg)

    def score_host_sample(pred_i, gt):
        """The numpy protocol on one sample -> (sums9, 0 or 1)."""
        pred_sq = np.asarray(pred_i, np.float32).squeeze()
        gt_sq = np.asarray(gt, np.float32).squeeze()
        if pred_sq.shape != gt_sq.shape and not (cfg.do_kb_crop and pred_sq.shape == (352, 1216)):
            # No protocol maps this pred onto this gt (the only shape-bridging
            # rule is the kb re-embed of a 352x1216 pred,
            # pytorch/bts_main.py:267-273): excluded, with a warning, so the
            # count of scored samples stays exact.
            warnings.warn(f"eval: cannot score sample with pred {pred_sq.shape} vs gt "
                          f"{gt_sq.shape}; excluded from metrics", stacklevel=2)
            return np.zeros(9, np.float64), 0
        pred, gt, mask = prepare_pred_gt(
            pred_i, gt, cfg.min_depth_eval, cfg.max_depth_eval, cfg.dataset,
            do_kb_crop=cfg.do_kb_crop, garg_crop=cfg.garg_crop, eigen_crop=cfg.eigen_crop)
        if not mask.any():
            return np.zeros(9, np.float64), 0
        return compute_errors(gt[mask], pred[mask]), 1

    def host(preds):
        return preds.cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)

    sums = np.zeros(9, dtype=np.float64)
    count = 0
    for batch in loader.batches():
        preds = forward(batch["image"], batch["focal"])
        if use_device:
            # Metrics on the predictions' device; the readback is 10 numbers.
            out = run_batch(batch_metrics, torch.as_tensor(preds), batch, cfg.dataset)
            if out is not None:
                sums += out[0]
                count += int(round(out[1]))
                # Samples whose gt shape cannot ride the batched metrics are
                # scored one by one, so every sample counts exactly once
                # (distributed_sampler_no_evenly_divisible.py:30-40).
                host_preds = host(preds) if out[2] else None
                for i in out[2]:
                    s, c = score_host_sample(host_preds[i], batch["depths"][i])
                    sums += s
                    count += c
            continue
        preds = host(preds)
        for i, w in enumerate(batch["weight"]):
            gt = batch["depths"][i]
            if w == 0 or gt is None:
                continue  # missing gt is tolerated (pytorch/bts_main.py:258-260)
            s, c = score_host_sample(preds[i], gt)
            sums += s
            count += c

    if nproc > 1:
        # The reference's dist.all_reduce(SUM) (pytorch/bts_main.py:302-304),
        # sent in f32 as bts_tpu sends it.
        vec = np.concatenate([sums, [count]]).astype(np.float32)
        vec = np.asarray(allgather_fn(vec)).sum(axis=0)
        sums, count = vec[:9].astype(np.float64), int(round(float(vec[9])))

    if pidx != 0:
        return None
    measures = sums / max(count, 1)
    if verbose:
        print(f"Computing errors for {count} eval samples")
        print(", ".join(f"{m:>7}" for m in EVAL_METRICS))
        print(", ".join(f"{v:7.3f}" for v in measures))
    return measures
