"""``average_checkpoints`` and ``cli.avg_checkpoints`` against bts_tpu's
average_checkpoints on the same two reference-form ``.pth`` files of a tiny
ResNeXt (DDP prefix, torchvision's fc), on the CPU."""

import functools

import jax
import numpy as np
import pytest
import torch

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.training import checkpoint as jcheckpoint
from bts_tpu_torch.cli import avg_checkpoints as cli_avg
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from bts_tpu_torch.training.checkpoint import average_checkpoints

from torch_zoo_helpers import model_variables, tiny_resnets  # noqa: F401

ENCODER = "tiny_resnext_bts"


@pytest.fixture
def reference_files(tiny_resnets, tmp_path):
    """A reference trainer's save and a bare (zoo-release) state dict of two
    differently seeded tiny ResNeXts, each with fc, BN statistics away from
    init and its own num_batches_tracked."""
    paths = []
    for seed in (1, 2):
        model = bts.create_model(Config(encoder=ENCODER, bts_size=128, seed=seed))
        gen = torch.Generator().manual_seed(seed)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.num_batches_tracked.fill_(100 * seed)
        state = {"module." + k: v for k, v in model.state_dict().items()}
        state["module.encoder.base_model.fc.weight"] = torch.randn(1000, 2048, generator=gen)
        state["module.encoder.base_model.fc.bias"] = torch.randn(1000, generator=gen)
        path = tmp_path / f"model-{seed}"
        torch.save({"model": state, "global_step": seed} if seed == 1 else state, path)
        paths.append(str(path))
    return paths


def test_average_matches_bts_tpu(reference_files, monkeypatch):
    """Every float tensor bit for bit with bts_tpu's average (float64 sums,
    cast back); num_batches_tracked, which bts_tpu's tree has not, is the
    first file's."""
    jmodel = jbts.create_model(JConfig(encoder=ENCODER, bts_size=128, fast_tail=False))
    params, stats = model_variables(jmodel, np.random.default_rng(0))
    monkeypatch.setattr(jcheckpoint, "load_any_checkpoint", functools.partial(
        jcheckpoint.load_any_checkpoint, template_params=params, template_stats=stats))
    jparams, jstats = jcheckpoint.average_checkpoints(reference_files)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jparams),
                                jax.tree.map(np.asarray, jstats))

    got = average_checkpoints(reference_files)
    assert got.keys() == want.keys()
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert v.dtype == torch.long and int(v) == 100
        else:
            assert v.dtype == torch.float32
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    first = load_checkpoint(reference_files[0])
    assert not torch.equal(got["decoder.conv1.0.weight"], first["decoder.conv1.0.weight"])


def test_cli_writes_a_loadable_average(reference_files, tmp_path):
    out = tmp_path / "avg.pth"
    assert cli_avg.main(["--out", str(out), *reference_files]) == 0
    saved = torch.load(out, weights_only=True)
    assert list(saved) == ["model"]
    want = average_checkpoints(reference_files)
    model = bts.create_model(Config(encoder=ENCODER, bts_size=128))
    model.load_state_dict(load_checkpoint(str(out)), strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_mismatched_checkpoints_raise(reference_files, tmp_path):
    state = load_checkpoint(reference_files[0])
    del state["decoder.conv1.0.weight"]
    other = tmp_path / "other.pth"
    torch.save(state, other)
    with pytest.raises(ValueError, match="differ by name"):
        average_checkpoints([reference_files[0], str(other)])
    with pytest.raises(ValueError, match="at least one"):
        average_checkpoints([])
