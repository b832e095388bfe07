"""The rule of ``models/graphed.py`` on the CPU: when BTSModel's forward
replays a CUDA graph, when it runs eager, what the signature holds, when
held graphs are dropped, and the counters. Where the card is needed, a
stand-in for ``graphed.Graph`` runs on the CPU as a graph would: capture
records the forward and its outputs, a replay recomputes into those outputs
and moves no launch counter itself. The graphs on the card are checked by
``chip_smoke.py``'s phase 15."""

import copy
import sys
import types

import pytest
import torch

from bts_tpu_torch import ops
from bts_tpu_torch.models import bts, graphed
from bts_tpu_torch.models.encoders import densenet
from bts_tpu_torch.ops import lpg_cuda

from torch_threads import one_thread  # noqa: F401 (fixture)

TINY = "tiny_graphed_densenet_bts"
H, W = 64, 96


class StandIn:
    device_type = "cpu"

    def __init__(self, device):
        self.device = device

    @staticmethod
    def capturing():
        return False

    def capture(self, fn):
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def replay(self, static, inputs, outputs):
        for s, t in zip(static, inputs):
            s.copy_(t)
        counts = {k: getattr(m, a) for k, (m, a) in ops.LAUNCH_COUNTERS.items()}
        for o, n in zip(outputs, self.fn(), strict=True):
            o.copy_(n)
        for k, (m, a) in ops.LAUNCH_COUNTERS.items():  # a replay runs no wrapper
            setattr(m, a, counts.get(k, 0))
        return tuple(o.clone() for o in outputs)


@pytest.fixture
def model(monkeypatch):
    monkeypatch.setitem(bts.ENCODERS, TINY, (lambda: densenet.DenseNetEncoder((2, 2, 2, 2), 8, 16),
                                             [16, 16, 16, 16, 32]))
    for name in ("CAPTURES", "REPLAYS", "EAGER_FORWARDS"):
        monkeypatch.setattr(graphed, name, 0)
    torch.manual_seed(0)
    return bts.BTSModel(encoder_name=TINY, bts_size=128).eval()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphed, "Graph", StandIn)


def inputs(seed=0, batch=2, h=H, w=W, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 3, h, w, generator=g).to(dtype), torch.full((batch,), 518.8579)


def counters():
    return graphed.CAPTURES, graphed.REPLAYS, graphed.EAGER_FORWARDS


def assert_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_forward_never_captures_or_counts(model):
    x, f = inputs()
    with torch.no_grad():
        want = model._forward(x, f)
        for _ in range(3):
            assert_equal(model(x, f), want)
    with torch.inference_mode():
        assert_equal(model(x, f), want)
    assert counters() == (0, 0, 0)
    assert not model.forward_graphs.graphs and not model.forward_graphs.seen


def test_replays_match_eager_and_count(model, stand_in, monkeypatch):
    """Eager, then capture (and replay), then replays; a signature seen once
    runs eager and captures nothing; every replay's launches counted."""
    eager_forward = model._forward

    def launching(*a):  # the kernels' wrappers count 3 launches an eager run
        lpg_cuda.LAUNCHES += 3
        return eager_forward(*a)

    monkeypatch.setattr(model, "_forward", launching)
    monkeypatch.setattr(lpg_cuda, "LAUNCHES", 0)
    x, f = inputs()
    with torch.inference_mode():
        want = eager_forward(x, f)
        got = [model(x, f) for _ in range(4)]
        assert counters() == (1, 3, 1)
        for g in got:
            assert_equal(g, want)
        assert lpg_cuda.LAUNCHES == 4 * 3  # the capture ran nothing
        # a shape seen once: eager, no capture; the held graph still replays
        odd = inputs(batch=1, h=32)
        assert_equal(model(*odd), eager_forward(*odd))
        assert counters() == (1, 3, 2)
        assert_equal(model(x, f), want)
        assert counters() == (1, 4, 2)
        assert lpg_cuda.LAUNCHES == 6 * 3


def test_a_counter_registered_during_a_capture_counts_its_replays(model, stand_in,
                                                                  monkeypatch):
    """A kernel module first imported by the captured forward registers its
    counter while the capture runs: the capture leaves it at 0, the count it
    had before, and each replay adds the capture's launches."""
    kernel = types.ModuleType("late_kernel")
    monkeypatch.setitem(sys.modules, "late_kernel", kernel)
    eager_forward = model._forward
    calls = []

    def launching(*a):
        calls.append(a)
        if len(calls) == 2:  # the capture imports the kernel's module
            kernel.LAUNCHES = 0
            ops.count_launches("late_kernel", "LAUNCHES")
        if len(calls) >= 2:
            kernel.LAUNCHES += 2
        return eager_forward(*a)

    monkeypatch.setattr(model, "_forward", launching)
    x, f = inputs()
    try:
        with torch.inference_mode():
            model(x, f)  # eager
            model(x, f)  # capture and replay
            assert counters() == (1, 1, 1) and kernel.LAUNCHES == 2
            model(x, f)
            assert counters() == (1, 2, 1) and kernel.LAUNCHES == 4
    finally:
        ops.LAUNCH_COUNTERS.pop("late_kernel.LAUNCHES", None)


def test_call_outputs_survive_the_next_call(model, stand_in):
    a, b = inputs(1), inputs(2)
    with torch.no_grad():
        want_a, want_b = model._forward(*a), model._forward(*b)
        model(*a), model(*a)  # eager, capture
        got_a = model(*a)
        got_b = model(*b)
    assert counters() == (1, 3, 1)
    assert_equal(got_a, want_a)
    assert_equal(got_b, want_b)


def test_alternating_shapes_are_both_captured(model, stand_in):
    a, b = inputs(batch=1), inputs(batch=2)
    with torch.no_grad():
        for x, f in (a, b, a, b, a, b):
            torch.testing.assert_close(model(x, f)[4], model._forward(x, f)[4], rtol=0, atol=0)
    assert counters() == (2, 4, 2)


def test_keeps_the_last_graphs(model, stand_in):
    shapes = [inputs(batch=b) for b in (1, 2, 3)]
    with torch.no_grad():
        for x, f in shapes:
            model(x, f), model(x, f)
        assert graphed.CAPTURES == 3 and len(model.forward_graphs.graphs) == graphed.KEEP == 2
        model(*shapes[0])  # evicted: eager again
        assert counters() == (3, 3, 4)
        model(*shapes[2])
        assert counters() == (3, 4, 4)


def _held(model, stand_in_calls=2):
    x, f = inputs()
    for _ in range(stand_in_calls):
        model(x, f)
    return x, f


@pytest.mark.parametrize("how", ["train", "grad", "train_mode_no_grad"])
def test_train_mode_or_grad_runs_eager_and_drops_graphs(model, stand_in, how):
    with torch.no_grad():
        x, f = _held(model)
    assert len(model.forward_graphs.graphs) == 1
    if how == "train":
        model.train()
        assert not model.forward_graphs.graphs  # at once, before any forward
        with torch.no_grad():
            model(x, f)
    elif how == "grad":
        out = model(x, f)
        assert out[4].requires_grad
    else:
        model.training = True  # as make_eval_forward restores the modes
        with torch.no_grad():
            model(x, f)
    assert not model.forward_graphs.graphs
    assert counters() == (1, 1, 2)


def test_eval_restores_no_graphs(model, stand_in):
    with torch.no_grad():
        _held(model)
        model.eval()
        assert len(model.forward_graphs.graphs) == 1


@pytest.mark.parametrize("change", [
    "weight_in_place", "load_state_dict", "to", "buffer_in_place", "parameter_assigned",
    "setting",
])
def test_new_weights_drop_the_graph(model, stand_in, change):
    with torch.no_grad():
        x, f = _held(model)
        conv = model.decoder.get_depth[0]
        if change == "weight_in_place":
            conv.weight.mul_(0.5)
        elif change == "load_state_dict":
            state = {k: v * 0.5 if v.is_floating_point() else v
                     for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            assert not model.forward_graphs.graphs  # at once
        elif change == "to":
            model.to(torch.float64).to(torch.float32)
            assert not model.forward_graphs.graphs
        elif change == "buffer_in_place":
            model.decoder.bn2.running_var.add_(1.0)
        elif change == "setting":
            model.encoder.dense_impl = "plain"
        else:
            conv.weight = torch.nn.Parameter(conv.weight * 0.5)
        want = model._forward(x, f)
        got = model(x, f)
        assert not model.forward_graphs.graphs  # the old weights' graph is gone
        assert counters() == (1, 1, 2)
        assert_equal(got, want)
        assert_equal(model(x, f), want)  # captured again on the new weights
        assert counters() == (2, 2, 2)


SIGNATURE_CHANGES = {
    "weight_in_place": lambda m, x, f: (m.encoder.base_model.conv0.weight.add_(1.0), (x, f))[1],
    "load_state_dict": lambda m, x, f: (m.load_state_dict(m.state_dict()), (x, f))[1],
    "batch": lambda m, x, f: (x[:1], f[:1]),
    "height": lambda m, x, f: (x[..., :32, :].contiguous(), f),
    "dtype": lambda m, x, f: (x.double(), f),
    "strides": lambda m, x, f: (x.contiguous(memory_format=torch.channels_last), f),
    "dense_impl": lambda m, x, f: (setattr(m.encoder, "dense_impl", "plain"), (x, f))[1],
    "lpg_impl": lambda m, x, f: (setattr(m.decoder, "lpg_impl", "xla"), (x, f))[1],
}


def _signature(model, x, f):
    return graphed.call_key((x, f)), graphed.module_state(model)


@pytest.mark.parametrize("change", sorted(SIGNATURE_CHANGES))
def test_signature_changes(model, change):
    x, f = inputs()
    with torch.no_grad():
        before = _signature(model, x, f)
        assert _signature(model, x, f) == before
        x2, f2 = SIGNATURE_CHANGES[change](model, x, f)
        assert _signature(model, x2, f2) != before


@pytest.mark.parametrize("dtypes", [(None, torch.bfloat16), (torch.bfloat16, torch.float16)])
def test_signature_holds_the_autocast_dtype(model, dtypes):
    x, f = inputs()
    sigs = []
    for dtype in dtypes:
        with torch.autocast("cpu", dtype=dtype or torch.bfloat16, enabled=dtype is not None):
            sigs.append(_signature(model, x, f))
    assert sigs[0] != sigs[1]


@pytest.mark.parametrize("flag", ["cudnn", "matmul"])
def test_signature_holds_the_tf32_flags(model, flag):
    x, f = inputs()
    owner = torch.backends.cudnn if flag == "cudnn" else torch.backends.cuda.matmul
    was = owner.allow_tf32
    before = _signature(model, x, f)
    try:
        owner.allow_tf32 = not was
        assert _signature(model, x, f) != before
    finally:
        owner.allow_tf32 = was
    assert _signature(model, x, f) == before


def test_signature_holds_inference_mode(model):
    x, f = inputs()
    with torch.no_grad():
        plain = _signature(model, x, f)
    with torch.inference_mode():
        assert _signature(model, x, f) != plain


@pytest.mark.parametrize("why", ["inference_weights", "forward_hook", "submodule_training"])
def test_runs_eager(model, stand_in, monkeypatch, why):
    if why == "inference_weights":
        with torch.inference_mode():
            model = bts.BTSModel(encoder_name=TINY, bts_size=128).eval()
    elif why == "forward_hook":
        model.decoder.register_forward_hook(lambda *a: None)
    else:
        model.decoder.bn2.train()
    x, f = inputs()
    with torch.inference_mode():
        want = model._forward(x, f) if why != "submodule_training" else None
        got = [model(x, f) for _ in range(3)]
    assert counters() == (0, 0, 3)
    if want is not None:
        for g in got:
            assert_equal(g, want)


def test_copies_start_empty(model, stand_in):
    with torch.no_grad():
        _held(model)
    clone = copy.deepcopy(model)
    assert len(model.forward_graphs.graphs) == 1
    assert not clone.forward_graphs.graphs and not clone.forward_graphs.seen


def test_replay_launches_before_the_state_check(model, stand_in, monkeypatch):
    """A replayed call reads only the call key before it launches; the
    module's state is read after, while the card runs the replay."""
    events = []
    replay, state = StandIn.replay, graphed.module_state
    monkeypatch.setattr(StandIn, "replay", lambda *a: (events.append("replay"), replay(*a))[1])
    monkeypatch.setattr(graphed, "module_state", lambda m: (events.append("state"), state(m))[1])
    x, f = inputs()
    with torch.no_grad():
        model(x, f), model(x, f)  # eager, capture (its state read before)
        events.clear()
        model(x, f)
    assert events == ["replay", "state"]
    assert counters() == (1, 2, 1)


class Stale(StandIn):
    """A graph whose replay returns what the weights at capture gave: here
    zeros, which no forward of the test's weights gives."""

    def replay(self, static, inputs, outputs):
        return tuple(torch.zeros_like(o) for o in outputs)


def test_a_stale_replay_is_dropped(model, monkeypatch):
    monkeypatch.setattr(graphed, "Graph", Stale)
    x, f = inputs()
    with torch.no_grad():
        model(x, f), model(x, f)  # eager, capture
        model.decoder.get_depth[0].weight.mul_(0.5)
        want = model._forward(x, f)
        got = model(x, f)
    assert_equal(got, want)
    assert not model.forward_graphs.graphs
    assert counters() == (1, 1, 2)  # the capturing call's replay; the stale one is not counted
