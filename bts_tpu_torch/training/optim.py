"""Optimizer assembly: AdamW param groups, poly LR, set_misc freezing.

Port of ``bts_tpu/training/optim.py``, whose optimizer is
``optax.multi_transform`` over three labels:

  * ``encoder``: ``optax.adamw(schedule, eps=adam_eps,
    weight_decay=cfg.weight_decay, mu_dtype=...)``;
  * ``decoder``: the same with weight decay 0 (the reference's two groups,
    pytorch/bts_main.py:371-373);
  * ``frozen``: ``optax.set_to_zero()`` -- here ``requires_grad_(False)``: no
    update, no decay, no moments.

``AdamW`` below is optax's ``adamw`` step for step, in plain PyTorch.
``torch.optim.AdamW`` differs in three places: it decays the weights before
the Adam step, places ``eps`` after the bias correction of the square root,
and cannot keep the first moment in bf16 (``--adam_bf16_moments``, optax's
``mu_dtype``).

Freezing follows the reference's ``set_misc`` substring rules
(pytorch/bts_main.py:217-247) on the port's torch names, per family as
``bts_tpu``'s ``frozen_predicate``:

  * DenseNet: the first conv (``base_model.conv0``), every encoder BN
    (``.norm``), and the first dense layer(s) under
    ``--fix_first_conv_block(s)``;
  * ResNet and ResNeXt: the stem conv and BN (``base_model.conv1``,
    ``base_model.bn1``) and every block's ``bn1/bn2/bn3``; the downsample
    BN (``downsample.1``) stays trainable, because the reference's ``.bn``
    substring does not match it; the first block(s) of ``layer1`` under
    ``--fix_first_conv_block(s)``;
  * MobileNetV2: nothing (the reference's substrings match none of its
    names).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bts_tpu_torch.config import Config
from bts_tpu_torch.training.lr import polynomial_decay

ENCODER_PREFIX = "encoder."
B1, B2 = 0.9, 0.999  # optax.adamw's defaults, which bts_tpu uses


def frozen_predicate(cfg: Config) -> Callable[[str], bool]:
    """fn(torch parameter name) -> whether set_misc freezes it."""
    if cfg.encoder == "mobilenetv2_bts":
        return lambda name: False
    base = ENCODER_PREFIX + "base_model."
    if "resne" in cfg.encoder:  # the reference's test ('resne' in encoder)
        first = (base + "conv1.",)  # the stem BN is bn1: a marker below
        bn_markers = (".bn1.", ".bn2.", ".bn3.")
        first_blocks = ("layer1.0.", "layer1.1.")
    else:
        first = (base + "conv0.",)
        bn_markers = (".norm",)
        first_blocks = ("denseblock1.denselayer1.", "denseblock1.denselayer2.")
    if cfg.fix_first_conv_blocks:
        blocks = tuple(base + b for b in first_blocks)
    elif cfg.fix_first_conv_block:
        blocks = (base + first_blocks[0],)
    else:
        blocks = ()

    def pred(name: str) -> bool:
        if not name.startswith(ENCODER_PREFIX):
            return False
        return name.startswith(first + blocks) or any(m in name for m in bn_markers)

    return pred


def param_labels(model: nn.Module, cfg: Config) -> Dict[str, str]:
    """Label each parameter 'frozen' | 'encoder' | 'decoder', by name."""
    pred = frozen_predicate(cfg)
    labels = {}
    for name, _ in model.named_parameters():
        if pred(name):
            labels[name] = "frozen"
        else:
            labels[name] = "encoder" if name.startswith(ENCODER_PREFIX) else "decoder"
    return labels


class AdamW:
    """``optax.adamw`` for each of several named groups of parameters.

    Each group keeps optax's own two counts: ``count`` (Adam's bias
    correction) and ``schedule_count`` (the LR schedule's). An update with
    gradient g of parameter p, in f32:

        mu = (1 - b1) * g + b1 * mu      (b1 * mu in mu's dtype)
        nu = (1 - b2) * g^2 + b2 * nu
        count += 1
        u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        u  = u + weight_decay * p
        p  = p + (-schedule(schedule_count)) * u;  schedule_count += 1

    ``mu`` is stored in ``mu_dtype`` (bf16 under ``--adam_bf16_moments``) after
    the update used it in f32, as optax casts it; ``nu`` stays f32. A
    parameter with no gradient counts as a zero gradient, as optax's updates
    always carry one.
    """

    def __init__(
        self,
        groups: Dict[str, Tuple[List[Tuple[str, nn.Parameter]], float]],
        schedule: Callable[[int], torch.Tensor],
        eps: float = 1e-8,
        mu_dtype: Optional[torch.dtype] = None,
    ):
        self.schedule = schedule
        self.eps = eps
        self.mu_dtype = mu_dtype
        self.groups = {
            gname: {"params": list(named), "weight_decay": wd, "count": 0, "schedule_count": 0}
            for gname, (named, wd) in groups.items()
        }
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    def named_params(self) -> Iterable[Tuple[str, nn.Parameter]]:
        for group in self.groups.values():
            yield from group["params"]

    def zero_grad(self) -> None:
        for _, p in self.named_params():
            p.grad = None

    def _moments(self, name: str, p: torch.Tensor):
        st = self.state.get(name)
        if st is None:
            st = self.state[name] = {
                "mu": torch.zeros_like(p, dtype=self.mu_dtype or p.dtype),
                "nu": torch.zeros_like(p),
            }
        return st

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = B1, B2
        for group in self.groups.values():
            count = group["count"] + 1
            # 1 - decay**count in f32, as optax's bias correction computes it.
            bc1 = (1.0 - torch.tensor(b1) ** float(count)).item()
            bc2 = (1.0 - torch.tensor(b2) ** float(count)).item()
            neg_lr = -float(self.schedule(group["schedule_count"]))
            wd = group["weight_decay"]
            consts = {}  # per device: the two corrections and b1 in bf16
            for name, p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self._moments(name, p)
                mu_old = st["mu"]
                if p.device not in consts:
                    # On the device: a CPU scalar divisor would turn the
                    # division into a multiply by its reciprocal on a card.
                    consts[p.device] = [torch.tensor(v, dtype=dt, device=p.device) for v, dt in (
                        (bc1, torch.float32), (bc2, torch.float32), (b1, mu_old.dtype))]
                bc1_t, bc2_t, b1_t = consts[p.device]
                # b1 * mu in mu's own dtype (bf16 under adam_bf16_moments),
                # with b1 in that dtype, then promoted: optax's arithmetic.
                mu = (1 - b1) * g + mu_old * b1_t
                nu = (1 - b2) * (g * g) + b2 * st["nu"]
                u = (mu / bc1_t) / (torch.sqrt(nu / bc2_t) + self.eps)
                if wd:
                    u = u + wd * p
                p.add_(neg_lr * u)
                st["mu"] = mu.to(mu_old.dtype)
                st["nu"] = nu
            group["count"] = count
            group["schedule_count"] += 1

    def applied_lr(self) -> float:
        """The LR the next update applies (every group shares the schedule
        and advances its count together)."""
        group = next(iter(self.groups.values()))
        return float(self.schedule(group["schedule_count"]))

    def state_dict(self) -> dict:
        """Plain tensors and numbers keyed by parameter name (loads with
        ``torch.load(weights_only=True)``)."""
        return {
            "format": "bts_tpu_torch.adamw",
            "groups": {
                gname: {"weight_decay": g["weight_decay"], "count": g["count"],
                        "schedule_count": g["schedule_count"],
                        "params": [n for n, _ in g["params"]]}
                for gname, g in self.groups.items()
            },
            "state": {n: dict(st) for n, st in self.state.items()},
        }

    def load_state_dict(self, sd: dict) -> None:
        """Load a ``state_dict()`` (this port's, or ``adamw_state_from_optax``'s
        of a bts_tpu run). The state is keyed by name, so each group's
        parameters are compared as a set; a parameter of another group, or a
        moment of another shape or of another dtype than this run keeps
        (``mu_dtype``, ``--adam_bf16_moments``), raises."""
        if not is_port_optimizer_state(sd):
            raise ValueError("not a bts_tpu_torch AdamW state dict")
        for gname, g in self.groups.items():
            saved = sd["groups"][gname]
            names = {n for n, _ in g["params"]}
            if set(saved["params"]) != names:
                differ = sorted(set(saved["params"]) ^ names)
                raise ValueError(f"optimizer group {gname!r}: the saved parameters differ "
                                 f"({len(differ)} names, e.g. {differ[:3]})")
            g["count"], g["schedule_count"] = int(saved["count"]), int(saved["schedule_count"])
        params = dict(self.named_params())
        state = {}
        for n, st in sd["state"].items():
            if n not in params:
                raise ValueError(f"optimizer state for {n!r}, which no group trains")
            p = params[n]
            for k, want in (("mu", self.mu_dtype or p.dtype), ("nu", p.dtype)):
                if st[k].dtype != want or st[k].shape != p.shape:
                    raise ValueError(f"{n}: saved {k} is {st[k].dtype} {tuple(st[k].shape)}, "
                                     f"this run keeps {want} {tuple(p.shape)}")
            state[n] = {k: v.to(device=p.device) for k, v in st.items()}
        self.state = state


def is_port_optimizer_state(sd) -> bool:
    """Whether ``sd`` is an ``AdamW.state_dict()`` (and not, say, the
    reference's ``torch.optim.AdamW`` state)."""
    return isinstance(sd, dict) and sd.get("format") == "bts_tpu_torch.adamw"


def advance_schedule_count(optimizer: AdamW, step: int) -> AdamW:
    """Position every group's LR-schedule count at ``step``.

    Used when resuming from a reference checkpoint: weights and global_step
    carry over but the optimizer state starts fresh, and the poly LR must
    continue from the restored step like both references do
    (pytorch/bts_main.py:456-458). Adam's bias-correction count stays 0, the
    right correction for the fresh (zero) moments.
    """
    for group in optimizer.groups.values():
        group["schedule_count"] = int(step)
    return optimizer


def _field(node, name: str, index: int):
    """Field ``name`` (position ``index``) of an optax NamedTuple, or of the
    dict or list that orbax restores it as without a template."""
    if isinstance(node, Mapping):
        return node[name] if name in node else list(node.values())[index]
    return node[index]


def adamw_state_from_optax(opt_state) -> dict:
    """bts_tpu's optimizer state as an ``AdamW.state_dict()``.

    ``opt_state`` is ``bts_tpu/training/optim.py``'s ``optax.multi_transform``
    state as a tree of numpy arrays: optax's NamedTuples, or the dicts and
    lists that orbax restores them as without a template (a masked leaf is
    None). Each node is read by field name where it has one, else by
    position: ``inner_states[label].inner_state`` is ``optax.adamw``'s chain
    (``ScaleByAdamState(count, mu, nu)``, the weight decay's empty state,
    ``ScaleByScheduleState(count)``). For ``encoder`` and ``decoder`` the
    Adam count becomes the group's ``count``, the schedule's its
    ``schedule_count``, and each unmasked ``mu``/``nu`` leaf the moment of
    the parameter of its torch name (``convert.tensors_from_flax``: kernels
    transposed, ``mu`` kept in its dtype, bf16 under
    ``--adam_bf16_moments``). ``frozen`` (``set_to_zero``) has no state, as
    here. The groups carry no weight decay: optax keeps it in the
    transform, not in the state, and ``load_state_dict`` does not read it."""
    from bts_tpu_torch.models.convert import tensors_from_flax

    inner = _field(opt_state, "inner_states", 0)
    groups, state = {}, {}
    for gname in ("encoder", "decoder"):
        chain = _field(inner[gname], "inner_state", 0)
        adam, schedule = _field(chain, "0", 0), _field(chain, "2", 2)
        mu = tensors_from_flax(_field(adam, "mu", 1))
        nu = tensors_from_flax(_field(adam, "nu", 2))
        if mu.keys() != nu.keys():
            raise ValueError(f"optax group {gname!r}: mu and nu hold other parameters")
        groups[gname] = {"count": int(np.asarray(_field(adam, "count", 0))),
                         "schedule_count": int(np.asarray(_field(schedule, "count", 0))),
                         "params": list(mu)}
        state.update({n: {"mu": mu[n], "nu": nu[n]} for n in mu})
    return {"format": "bts_tpu_torch.adamw", "groups": groups, "state": state}


def create_optimizer(cfg: Config, model: nn.Module, num_total_steps: int):
    """(optimizer, schedule) with the reference's param groups and freezing.
    Frozen parameters get ``requires_grad_(False)``."""
    schedule = polynomial_decay(
        cfg.learning_rate, cfg.resolved_end_learning_rate, num_total_steps, power=0.9
    )
    labels = param_labels(model, cfg)
    named = {"encoder": [], "decoder": []}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            named[labels[name]].append((name, p))
    groups = {"encoder": (named["encoder"], cfg.weight_decay), "decoder": (named["decoder"], 0.0)}
    mu_dtype = torch.bfloat16 if cfg.adam_bf16_moments else None
    return AdamW(groups, schedule, eps=cfg.adam_eps, mu_dtype=mu_dtype), schedule
