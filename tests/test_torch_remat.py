"""Rematerialisation (``--remat``, ``--remat_policy``, ``--remat_scope``;
``bts_tpu_torch/models/remat.py``) on the CPU in f32, at the tiny sizes of
tests/test_torch_train_step.py: the port's remat step against bts_tpu's, and
against the port's own step without remat; what the ``conv`` policy saves;
inference untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts, remat
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.training import optim, state

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from test_torch_tf_train import TINY_TF, _register as register_tiny_tf
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W, cfgs, tiny_variables
from torch_zoo_helpers import tiny_resnets  # noqa: F401 (fixture)

SETTINGS = [("conv", "encoder"), ("conv", "all"), ("full", "encoder"), ("full", "all")]
IDS = [f"{p}-{s}" for p, s in SETTINGS]


def _kw(encoder, **kw):
    """test_torch_train_step.py's fields."""
    return dict(encoder=encoder, dataset="nyu", max_depth=10.0, bts_size=128, fast_tail=False,
                lpg_impl="pallas", learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3,
                batch_size=2, input_height=H, input_width=W, **kw)


def _batches(seed=4, n=2):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(2, H, W, 3)).astype(np.float32),
             "depth": rng.uniform(0.0, 10.0, (2, H, W, 1)).astype(np.float32),
             "focal": np.array([518.8579, 518.8579], np.float32)} for _ in range(n)]


def _port_steps(cfg, state_dict, batches):
    """The port's train steps from ``state_dict``: (losses, each step's
    gradients by name, the state dict after the steps)."""
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st = state.TrainState(model, opt)
    step = state.make_train_step(cfg)
    losses, grads = [], []
    for b in batches:
        losses.append(step(st, {k: torch.from_numpy(v) for k, v in b.items()}))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    return losses, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("policy,scope", [("conv", "encoder"), ("full", "all")],
                         ids=["conv-encoder", "full-all"])
def test_remat_steps_match_bts_tpu(tiny_encoder, policy, scope):
    """Two steps of the port with remat against bts_tpu's make_train_step with
    the same remat (its encoder under nn.remat with the policy, its decoder
    too under scope 'all'), BN in train mode, f32: the loss at rtol 1e-5,
    parameters and BN statistics after the two steps at atol 1e-5
    (test_torch_train_step.py's tolerances)."""
    cfg, jcfg = cfgs(**_kw(tiny_encoder, remat=True, remat_policy=policy, remat_scope=scope))
    jmodel, params, stats = tiny_variables(tiny_encoder, jcfg, seed=3)
    assert (jmodel.remat, jmodel.remat_policy, jmodel.remat_scope) == (True, policy, scope)
    sd = state_dict_from_flax(params, stats)
    batches = _batches()
    tx, _ = joptim.create_optimizer(jcfg, params, 50)
    jstep = jax.jit(jstate.make_train_step(jmodel, tx, jcfg))
    jst = jstate.create_train_state(params, stats, tx)
    jlosses = []
    for b in batches:
        jst, metrics = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(metrics["loss"]))

    losses, _, got = _port_steps(cfg, sd, batches)
    np.testing.assert_allclose([float(v) for v in losses], jlosses, rtol=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jst.params),
                                jax.tree.map(np.asarray, jst.batch_stats))
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=n)
    moved = [n for n in want if n.endswith("running_mean") and not torch.equal(got[n], sd[n])]
    assert moved


CASES = [("densenet", p, s) for p, s in SETTINGS] + [
    ("densenet_bf16", "full", "all"), ("resnet", "conv", "all"), ("tf_graph", "full", "all")]


@pytest.mark.parametrize("model,policy,scope", CASES,
                         ids=[f"{m}-{p}-{s}" for m, p, s in CASES])
def test_remat_step_equals_plain_step(request, monkeypatch, model, policy, scope):
    """The port's two steps with remat against its two steps without, from
    the same state on the same batches: the losses, every gradient of both
    steps, every parameter and every BN buffer (running_mean, running_var,
    num_batches_tracked) after them, bit for bit. The recompute runs the
    forward's own ops on the same inputs, so its tensors equal the saved
    ones, and it puts the BN buffers back as it found them: a BN that updated
    twice a step would move its statistics (momentum applied twice) and count
    num_batches_tracked 4 after two steps. The tiny DenseNet under each
    setting, and in bf16 autocast (the recompute restores autocast, so its
    convolutions run in bf16 as the forward's did), a tiny ResNet (its
    downsample BN too) and the TF graph (every BN frozen: its buffers stay
    as they were)."""
    dtype = "bfloat16" if model == "densenet_bf16" else "float32"
    if model.startswith("densenet"):
        encoder, flavor = request.getfixturevalue("tiny_encoder"), "pt"
    elif model == "resnet":
        request.getfixturevalue("tiny_resnets")
        encoder, flavor = "tiny_resnet_bts", "pt"
    else:
        register_tiny_tf(monkeypatch)
        encoder, flavor = TINY_TF, "tf"
    kw = _kw(encoder, model_flavor=flavor, compute_dtype=dtype)
    sd = bts.create_model(Config(**kw)).state_dict()
    batches = _batches()
    want_losses, want_grads, want = _port_steps(Config(**kw), sd, batches)
    losses, grads, got = _port_steps(
        Config(**kw, remat=True, remat_policy=policy, remat_scope=scope), sd, batches)
    for g, w in zip(losses, want_losses, strict=True):
        assert torch.equal(g, w), (float(g), float(w))
    for g, w in zip(grads, want_grads, strict=True):
        assert g.keys() == w.keys()
        for n in w:
            assert torch.equal(g[n], w[n]), n
    assert got.keys() == want.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n
    tracked = {n: int(v) for n, v in got.items() if n.endswith("num_batches_tracked")}
    assert tracked
    assert set(tracked.values()) == ({0} if flavor == "tf" else {len(batches)})
    if flavor == "tf":
        for n, v in got.items():
            if "running_" in n or n.endswith("num_batches_tracked"):
                assert torch.equal(v, sd[n]), n


class _ConvCount(TorchDispatchMode):
    """Counts the convolutions run while it is on, by their weights' data."""

    def __init__(self):
        super().__init__()
        self.weights = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.convolution.default:
            self.weights.append(args[1].data_ptr())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,scope", SETTINGS, ids=IDS)
def test_policy_decides_which_convolutions_run_again(tiny_encoder, policy, scope):
    """The convolutions that run during backward() (the recompute's), counted
    by a TorchDispatchMode: under 'conv' none of the encoder's, under 'full'
    every one of them once; the decoder's every one once under scope 'all',
    none under 'encoder'."""
    cfg = Config(**_kw(tiny_encoder, remat=True, remat_policy=policy, remat_scope=scope))
    model = state.set_bn_mode(bts.create_model(cfg), cfg)
    b = {k: torch.from_numpy(v) for k, v in _batches(n=1)[0].items()}
    loss = state.forward_loss(model, b["image"].permute(0, 3, 1, 2), b["depth"], b["focal"], cfg)
    with _ConvCount() as count:
        loss.backward()
    convs = {part: sorted(m.weight.data_ptr() for m in getattr(model, part).modules()
                          if isinstance(m, torch.nn.Conv2d)) for part in ("encoder", "decoder")}
    again = {part: sorted(w for w in count.weights if w in ptrs) for part, ptrs in convs.items()}
    assert again["encoder"] == ([] if policy == "conv" else convs["encoder"])
    assert again["decoder"] == (convs["decoder"] if scope == "all" else [])
    assert len(count.weights) == len(again["encoder"]) + len(again["decoder"])


@pytest.mark.parametrize("policy,scope", SETTINGS, ids=IDS)
def test_decoder_recompute_calls_lpg_forward_again(tiny_encoder, monkeypatch, policy, scope):
    """The LPG forward's calls in a train step (its plain version here, the
    kernel on a card): 3 in the forward, and 3 more in the backward under
    scope 'all', where the decoder's recompute calls it again; 3 LPG
    backward calls under every setting."""
    from bts_tpu_torch.ops import lpg

    calls = {"forward": 0, "backward": 0}
    for name, kind in (("lpg_scaled_reference", "forward"), ("lpg_backward_scaled", "backward")):
        def counted(*a, _fn=getattr(lpg, name), _kind=kind):
            calls[_kind] += 1
            return _fn(*a)

        monkeypatch.setattr(lpg, name, counted)
    cfg = Config(**_kw(tiny_encoder, remat=True, remat_policy=policy, remat_scope=scope))
    model = state.set_bn_mode(bts.create_model(cfg), cfg)
    b = {k: torch.from_numpy(v) for k, v in _batches(n=1)[0].items()}
    loss = state.forward_loss(model, b["image"].permute(0, 3, 1, 2), b["depth"], b["focal"], cfg)
    assert calls == {"forward": 3, "backward": 0}
    loss.backward()
    assert calls == {"forward": 6 if scope == "all" else 3, "backward": 3}


def test_inference_enters_no_region(tiny_encoder, monkeypatch):
    """A forward under no_grad or inference_mode of a model built with remat
    computes what the model without remat computes, bit for bit, and enters
    no checkpoint region; a forward that autograd records enters two under
    scope 'all'."""
    regions = []
    checkpoint = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **k: regions.append(1) or
                        checkpoint(*a, **k))
    kw = _kw(tiny_encoder)
    plain = bts.create_model(Config(**kw)).eval()
    model = bts.create_model(Config(**kw, remat=True, remat_policy="full", remat_scope="all"))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, H, W)).astype(np.float32))
    focal = torch.full((2,), 518.8579)
    with torch.no_grad():
        want = plain(x, focal)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            got = model(x, focal)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    assert regions == []
    model(x, focal)
    assert len(regions) == 2
