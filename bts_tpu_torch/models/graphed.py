"""CUDA graphs of a module's inference forward.

A forward on a card in eval mode with grad disabled (``inference_mode`` or
``no_grad``) launches a few hundred kernels, each from Python; at batch 8
the card finishes them faster than the host dispatches them.
``ForwardGraphs`` replays such a forward as one CUDA graph instead, one
graph per call key:

- the first forward of a key runs eager (it warms cuDNN, the autocast casts
  and the modules' own caches, such as ``DenseLayer.folded``);
- the next forward of the same key and module state captures the module's
  forward into a graph (``torch.cuda.CUDAGraph``, on a side stream of the
  inputs' device, under the caller's autocast dtype with the cast cache off,
  so that every cast is a node of the graph);
- from then on a call copies the inputs into the graph's static buffers,
  replays the graph on the current stream and returns clones of its static
  outputs, so that call n's outputs survive call n+1.

The kernels are the eager forward's, in its order, with its dtypes; the
fused kernels' TMA tensor maps are encoded once, at capture.

Before a replay the host reads only the call key (``call_key``): each
input's shape, strides, dtype and device, the autocast state and dtype of
the device type, whether inference mode is on, and the TF32 flags. The
module's state (``module_state``) is read while the card runs the replay:
the ``(data_ptr, _version)`` of every parameter and buffer, and the plain
settings of the program's own modules (``dense_impl``, ``lpg_impl``,
``max_depth``, ...). When it differs from the state at capture (weights
changed in place or reassigned, a setting changed), the replay's outputs
are dropped with every held graph and the call runs as a call with no
graph; so a replay's outputs are only ever returned for the weights it was
captured on. A graph keeps alive what it reads by address (the parameters
and buffers it was captured on, the modules' cached tensors), so a replay
on moved weights reads the old ones, never freed memory. ``train()``,
``.to()`` and ``load_state_dict`` drop the graphs at once
(``GraphedForward``, which every model of the zoo extends).

Everything else runs eager: CPU and meta tensors, train mode or grad
enabled (which also drop the held graphs, so that training does not hold
their memory), a submodule in train mode or with a forward hook (a replay
would run neither the hook nor the statistics' update), a forward inside
another capture, and weights that are inference tensors (they have no
version counter, so a change to them cannot be seen; ``DenseLayer.folded``
makes the same choice). At most ``KEEP`` graphs are held per module, the
last keys replayed; a key is captured at its second call among the module's
last ``KEEP`` eager forwards, so one seen once costs one eager forward and
no capture.

Counters, each bumped in one place: ``CAPTURES``, ``REPLAYS`` (calls that
returned a replay's outputs; a capturing call replays too) and
``EAGER_FORWARDS`` (card forwards that ran eager); the hit share is
REPLAYS / (REPLAYS + EAGER_FORWARDS). The spans ``bts/forward_capture`` and
``bts/forward_graph`` (the replay) name them in a profile. The kernels'
launch counters, which each kernel module registers in
``ops.LAUNCH_COUNTERS``, count launches that run: a capture runs nothing,
and each replay adds the launches its capture recorded, also one whose
outputs the state check then drops.

One caller at a time: a module's graphs share their static buffers between
calls (a replay waits for the previous replay of its graph on any stream,
but concurrent calls from several threads are not supported).
"""

from __future__ import annotations

import collections
import operator
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.modules import module as nn_module
from torch.profiler import record_function

from bts_tpu_torch.ops import LAUNCH_COUNTERS

# Forwards in this process; each bumped in one place.
CAPTURES = 0
REPLAYS = 0
EAGER_FORWARDS = 0

KEEP = 2  # graphs held per module

_SETTINGS = (str, int, float, bool, type(None))
_VERSION = operator.attrgetter("_version")


def launch_counts() -> Dict[str, int]:
    """The value of each counter of ``ops.LAUNCH_COUNTERS``, by name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in LAUNCH_COUNTERS.items()}


def _set_launches(counts: Mapping[str, int]) -> None:
    """Set each registered counter to its value in ``counts``; one that
    ``counts`` lacks (its module was imported since) to 0."""
    for name, (mod, attr) in LAUNCH_COUNTERS.items():
        setattr(mod, attr, counts.get(name, 0))


def call_key(inputs: Sequence[torch.Tensor]) -> tuple:
    """What a replay cannot see of the call itself: the inputs' shape,
    strides, dtype and device, the autocast state and dtype, inference mode
    and the TF32 flags."""
    kind = inputs[0].device.type
    return (tuple((t.shape, t.stride(), t.dtype, t.device) for t in inputs),
            torch.is_autocast_enabled(kind), torch.get_autocast_dtype(kind),
            torch.is_inference_mode_enabled(), torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _modules(module: nn.Module) -> list:
    """``module`` and its submodules, depth first (a shared one may come twice)."""
    found, stack = [], [module]
    while stack:
        m = stack.pop()
        found.append(m)
        stack.extend(c for c in m._modules.values() if c is not None)
    return found


def module_state(module: nn.Module) -> Optional[tuple]:
    """What a replay cannot see of the module: (every parameter's and
    buffer's data_ptr, their versions, the plain settings (str, number, bool,
    None) of the modules outside ``torch.nn``), or None when the forward
    must run eager: a module in train mode or with a forward hook, a global
    forward hook, weights that are inference tensors."""
    if nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks:
        return None
    tensors, settings = [], []
    for m in _modules(module):
        if m.training or m._forward_hooks or m._forward_pre_hooks:
            return None
        tensors += [t for t in (*m._parameters.values(), *m._buffers.values()) if t is not None]
        if not type(m).__module__.startswith("torch."):
            settings += [v for k, v in vars(m).items() if k[0] != "_" and type(v) in _SETTINGS]
    try:
        versions = tuple(map(_VERSION, tensors))
    except RuntimeError:  # an inference tensor has no version counter
        return None
    return tuple(map(torch.Tensor.data_ptr, tensors)), versions, tuple(settings)


def _read_by_address(module: nn.Module) -> list:
    """What a graph of ``module``'s forward reads by address outside its
    pool: every parameter and buffer, and the modules' cached tensors (the
    dense layers' folded weights, Marigold's noise and time-embedding
    inputs by shape)."""
    held = []
    for m in _modules(module):
        held += [*m._parameters.values(), *m._buffers.values()]
        for v in vars(m).values():
            if isinstance(v, (torch.Tensor, tuple)):
                held.append(v)
            elif isinstance(v, dict):
                held += [c for c in v.values() if isinstance(c, (torch.Tensor, tuple))]
    return held


class Graph:
    """One captured forward on a card: ``torch.cuda.CUDAGraph`` captured on a
    side stream of ``device``, replayed on the current stream."""

    device_type = "cuda"

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.done = torch.cuda.Event()  # recorded after each replay's outputs are cloned

    @staticmethod
    def capturing() -> bool:
        return torch.cuda.is_current_stream_capturing()

    def capture(self, fn: Callable):
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                return fn()

    def replay(self, static: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
               outputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        with torch.cuda.device(self.device):
            torch.cuda.current_stream().wait_event(self.done)
            for s, t in zip(static, inputs):
                s.copy_(t)
            self.graph.replay()
            clones = tuple(o.clone() for o in outputs)
            self.done.record()
        return clones


class _Entry:
    def __init__(self, state, graph, static, outputs, launches, held):
        self.state = state  # module_state at capture
        self.graph, self.static, self.outputs = graph, static, outputs
        self.launches = launches  # kernel launches the capture recorded, by counter
        self.held = held  # what the graph reads by address outside its pool


class ForwardGraphs:
    """The CUDA graphs of one module's inference forward (module docstring).
    ``__call__(module, forward, *inputs)`` runs ``forward(*inputs)`` (the
    module's eager forward) eager, or replays its graph."""

    def __init__(self):
        # by call key, the last replayed last
        self.graphs: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
        self.seen = collections.deque(maxlen=KEEP)  # (call key, state) of the last eager forwards

    def __reduce__(self):
        return ForwardGraphs, ()  # a copy starts empty: these graphs read this module's buffers

    def clear(self) -> None:
        """Drop every held graph (its memory pool goes with it)."""
        self.graphs.clear()
        self.seen.clear()

    def __call__(self, module: nn.Module, forward: Callable, *inputs: torch.Tensor):
        global REPLAYS
        if inputs[0].device.type != Graph.device_type:
            return forward(*inputs)
        if module.training or torch.is_grad_enabled():
            self.clear()
            return self._eager(forward, inputs)
        if Graph.capturing():
            return self._eager(forward, inputs)
        call = call_key(inputs)
        entry = self.graphs.get(call)
        outputs = None if entry is None else self._replay(entry, inputs)
        state = module_state(module)  # while the card runs the replay
        if outputs is not None and state == entry.state:
            self.graphs.move_to_end(call)
            REPLAYS += 1
            return outputs
        if state is None:
            self.clear()
            return self._eager(forward, inputs)
        for stale in [c for c, e in self.graphs.items() if e.state != state]:
            del self.graphs[stale]  # the module moved since their capture
        if (call, state) not in self.seen:
            self.seen.append((call, state))
            return self._eager(forward, inputs)
        self.seen.remove((call, state))
        outputs = self._replay(self._capture(module, forward, inputs, call, state), inputs)
        REPLAYS += 1
        return outputs

    def _eager(self, forward: Callable, inputs):
        global EAGER_FORWARDS
        EAGER_FORWARDS += 1
        return forward(*inputs)

    def _capture(self, module: nn.Module, forward: Callable, inputs, call, state) -> _Entry:
        global CAPTURES
        static = [torch.empty_like(t).copy_(t) for t in inputs]
        kind = inputs[0].device.type
        graph = Graph(inputs[0].device)
        before = launch_counts()
        try:
            with record_function("bts/forward_capture"), torch.autocast(
                    kind, dtype=torch.get_autocast_dtype(kind),
                    enabled=torch.is_autocast_enabled(kind), cache_enabled=False):
                outputs = graph.capture(lambda: forward(*static))
            launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
        finally:
            _set_launches(before)  # a capture runs nothing
        entry = _Entry(state, graph, static, outputs, launches, _read_by_address(module))
        CAPTURES += 1
        self.graphs[call] = entry
        while len(self.graphs) > KEEP:
            self.graphs.popitem(last=False)
        return entry

    def _replay(self, entry: _Entry, inputs):
        with record_function("bts/forward_graph"):
            outputs = entry.graph.replay(entry.static, inputs, entry.outputs)
        _set_launches({k: n + entry.launches.get(k, 0) for k, n in launch_counts().items()})
        return outputs


def drop_graphs(module: nn.Module, *_) -> None:
    """A ``load_state_dict`` post-hook: the module's graphs read the old
    weights' buffers."""
    module.forward_graphs.clear()


class GraphedForward(nn.Module):
    """A model of the zoo (``models/__init__.py``): ``forward(x, focal)``
    runs ``self._forward`` through ``ForwardGraphs``, so an inference forward
    on a card replays a CUDA graph of it from the second call of a call key
    on. ``train()``, ``.to()`` and ``load_state_dict`` drop the held graphs.

    Each model class declares what its callers need to know of it:

    - ``OUTPUTS``: the names of the tensors its forward returns, in order,
      each (B, 1, H, W) float32, the depth map always last (``"depth"``), so
      a caller that wants the depth takes ``[-1]``;
    - ``TRAINS``: whether this port trains it; a train step refuses a model
      whose ``TRAINS`` is false (``models.check_trainable``);
    - ``PAD_MULTIPLE``: the multiple that ``apps/predict.forward_padded``
      edge-pads H and W up to before the forward (1: none, for a model that
      resizes its frame itself);
    - ``NORMALIZATION``: the input statistics its weights read, which
      ``--normalization auto`` resolves to (``Config.resolved_normalization``)."""

    NORMALIZATION = "imagenet"

    def __init__(self):
        super().__init__()
        self.forward_graphs = ForwardGraphs()
        self.register_load_state_dict_post_hook(drop_graphs)

    def forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.forward_graphs(self, self._forward, x, focal)

    def train(self, mode: bool = True):
        if mode:
            self.forward_graphs.clear()
        return super().train(mode)

    def _apply(self, fn, recurse=True):
        self.forward_graphs.clear()
        return super()._apply(fn, recurse)
