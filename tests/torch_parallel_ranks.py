"""What each rank of tests/test_torch_parallel.py's and
tests/test_torch_train_loop.py's gloo jobs runs. The ranks import this module
(and no jax): each registers the tiny DenseNet-BTS of tests/test_torch_model.py
under its name, runs the checks its job file names, and returns its results
to the parent, which compares them."""

import numpy as np
import torch

from bts_tpu_torch.models import bts
from bts_tpu_torch.models.encoders import densenet

TINY = "tiny_densenet_bts"  # tests/test_torch_model.py's names and widths
TINY_CHANNELS = [16, 16, 16, 16, 32]


def register_tiny():
    bts.ENCODERS[TINY] = (lambda: densenet.DenseNetEncoder((2, 2, 2, 2), 8, 16), TINY_CHANNELS)


def train_steps(cfg, state_dict, batches, dp=None):
    """The port's train steps on ``batches`` (numpy, global), on this rank's
    share of each when ``dp`` is given: (losses, step 1's gradients by name,
    the state dict after the steps)."""
    from bts_tpu_torch.parallel.mesh import local_slice
    from bts_tpu_torch.training import optim, state

    model = bts.create_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st = state.TrainState(model, opt)
    step = state.make_train_step(cfg, dp)
    losses, grads = [], None
    for b in batches:
        if dp is not None:
            b = local_slice(b, dp.world, dp.rank)
        losses.append(float(step(st, {k: torch.from_numpy(v) for k, v in b.items()})))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return losses, grads, {k: v.clone() for k, v in model.state_dict().items()}, model


def parallel_job(path, cfg, dp):
    """tests/test_torch_parallel.py's checks on one rank; ``path`` holds the
    parent's inputs (torch.save of a dict)."""
    from bts_tpu_torch.evaluation import online
    from bts_tpu_torch.parallel.inference import make_sharded_forward
    from bts_tpu_torch.parallel.mesh import wrap_data_parallel

    register_tiny()
    inputs = torch.load(path, weights_only=False)
    out = {"world": dp.world, "rank": dp.rank}
    models = {}
    for mode, (mcfg, sd, batches) in inputs["train"].items():
        losses, grads, after, models[mode] = train_steps(mcfg, sd, batches, dp)
        out[mode] = {"losses": losses, "grads": grads, "state": after}
    losses, grads, after, _ = train_steps(*inputs["remat"], dp)
    out["remat"] = {"losses": losses, "grads": grads, "state": after}
    # The trained model's BN are global now; a replica of it serves alone.
    x = torch.from_numpy(inputs["serve"]["image"])
    f = torch.from_numpy(inputs["serve"]["focal"])
    out["serve"] = make_sharded_forward(models["bn_train"], ["cpu"], mcfg)(x, f)[0]

    ecfg, esd = inputs["eval"]
    model = bts.create_model(ecfg)
    model.load_state_dict(esd, strict=True)
    out["eval"] = online.run_online_eval(model, ecfg, verbose=False)
    sent = []

    def recording(vec):
        sent.append(np.array(vec, copy=True))
        return online.allgather_vector(vec)

    online.run_online_eval(model, ecfg, verbose=False, allgather_fn=recording)
    out["eval_sent"] = sent[0]

    # Ranks seeded alike, rank 1 perturbed: the wrap broadcasts rank 0's.
    model = bts.create_model(mcfg)
    model.load_state_dict(inputs["train"]["bn_train"][1], strict=True)
    if dp.rank == 1:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                t.add_(1)
    wrap_data_parallel(model, dp)
    out["wrapped"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def preempted_train(cfg, dp):
    """One rank of tests/test_torch_train_loop.py's two-rank loop: rank 1
    alone sees a termination request from step 2 on."""
    from bts_tpu_torch.training import loop

    register_tiny()
    steps = []

    class Guard(loop.PreemptionGuard):
        @property
        def requested(self):
            steps.append(1)
            return dp.rank == 1 and len(steps) >= 2

    loop.PreemptionGuard = Guard
    return loop.train(cfg, dp=dp)
