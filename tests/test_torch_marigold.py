"""Marigold v1-0 (``--encoder marigold_v1_0``) on the CPU at a tiny size (a
U-Net of two levels, 64 and 128 channels in heads of 64, a context of 64; a
VAE of two levels, 32 and 64 channels; 2 DDIM steps; processing resolution
48, so 16x24 frames are processed at 32x48: a 16x24 latent, 384 and 96
tokens), held to the plain float32 reference (``tests/marigold_reference.py``)
on seeded weights away from init; the DDIM schedule against its closed form;
planted faults that each move the depth past the test's gate; the tiny
widths served by every serving path and refused by training."""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import marigold_reference
from bts_tpu_torch import ops
from bts_tpu_torch.apps import live3d, predict
from bts_tpu_torch.cli import sequence as cli_sequence
from bts_tpu_torch.cli import test as cli_test
from bts_tpu_torch.cli import train as cli_train
from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.online import run_online_eval
from bts_tpu_torch.models import create_model, marigold
from bts_tpu_torch.tools import bench
from bts_tpu_torch.training.state import TrainState

from torch_threads import one_thread  # noqa: F401 (fixture)

TINY = dict(unet_channels=(64, 128), context_dim=64, vae_channels=(32, 64), layers=2, latent=4,
            processing_res=48, steps=2, noise_seed=3)
REFERENCE = {
    "min_depth": 1e-3, "max_depth": 10.0, "processing_res": 48, "denoise_steps": 2,
    "noise_seed": 3,
    "unet": {"block_out_channels": [64, 128], "layers_per_block": 2, "attention_head_dim": [1, 2],
             "cross_attention_dim": 64, "in_channels": 8, "out_channels": 4},
    "vae": {"block_out_channels": [32, 64], "layers_per_block": 2, "latent_channels": 4,
            "scaling_factor": 0.18215},
    "scheduler": {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                  "steps_offset": 1},
}
H, W = 16, 24
# Both sides are float32 on the CPU and compute the same equations, some in
# another order (the attention's blocks and scale, the resize's antialiased
# form, which equals bilinear when upsampling): 1e-4 leaves room, and each
# planted fault below moves the depth by far more.
TOL = dict(rtol=1e-4, atol=1e-4)
# The functions that two planted faults wrap, as the program has them.
REAL_TIMESTEP_EMBEDDING, REAL_DDIM_SCHEDULE = marigold.timestep_embedding, marigold.ddim_schedule


@pytest.fixture(scope="module")
def weights():
    """The reference's state dict away from init: matrices of variance
    1 / fan-in, norms and biases off identity, the empty-text embedding of
    std 1, so that dropping or misplacing any of them shows."""
    ref = marigold_reference.Marigold(REFERENCE)
    gen = torch.Generator().manual_seed(26)
    state = {}
    for k, v in ref.state_dict().items():
        if k == "empty_text_embed":
            state[k] = torch.randn(v.shape, generator=gen)
        elif v.dim() >= 2:
            state[k] = torch.randn(v.shape, generator=gen) / math.sqrt(v[0].numel())
        else:
            base = 1.0 if k.endswith("weight") else 0.0
            state[k] = base + 0.1 * torch.randn(v.shape, generator=gen)
    return state


@pytest.fixture(scope="module")
def image():
    return torch.rand(2, 3, H, W, generator=torch.Generator().manual_seed(0)) * 2 - 1


def models(state):
    ref = marigold_reference.Marigold(REFERENCE).eval()
    ref.load_state_dict(state, strict=True)
    port = marigold.MarigoldModel(10.0, 1e-3, **TINY).eval()
    port.load_state_dict(state, strict=True)
    return ref, port


def depth_of(model, x):
    with torch.no_grad():
        out = model(x, torch.full((x.shape[0],), 518.8579))
    return out[-1] if isinstance(out, tuple) else out


@pytest.fixture(scope="module")
def reference_depth(weights, image):
    return depth_of(models(weights)[0], image)


def test_state_dict_names_are_the_references():
    ref = marigold_reference.Marigold(REFERENCE).state_dict()
    port = marigold.MarigoldModel(10.0, 1e-3, **TINY).state_dict()
    assert list(port) == list(ref)
    assert all(port[k].shape == v.shape for k, v in ref.items())
    for key in ("unet.down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k.weight",
                "unet.up_blocks.1.resnets.2.conv_shortcut.weight",
                "vae.decoder.mid_block.attentions.0.to_out.0.bias",
                "vae.encoder.down_blocks.0.downsamplers.0.conv.weight", "empty_text_embed"):
        assert key in port
    with torch.device("meta"):
        big = marigold.MarigoldModel(**marigold.VERSIONS["marigold_v1_0"])
    assert sum(p.numel() for p in big.unet.parameters()) == 865_922_244
    assert sum(p.numel() for p in big.vae.parameters()) == 83_653_863
    assert sum(p.numel() for p in big.parameters()) == 865_922_244 + 83_653_863 + 77 * 1024


def test_depth_matches_reference(weights, image, reference_depth):
    """The tiny port equals the reference; a forward counts its 2 U-Net
    calls in the counter that ``ops.LAUNCH_COUNTERS`` registers."""
    assert ops.LAUNCH_COUNTERS[f"{marigold.__name__}.UNET_CALLS"] == (marigold, "UNET_CALLS")
    calls = marigold.UNET_CALLS
    depth = depth_of(models(weights)[1], image)
    assert marigold.UNET_CALLS == calls + 2
    assert depth.shape == (2, 1, H, W) and depth.dtype == torch.float32
    torch.testing.assert_close(depth, reference_depth, **TOL)
    assert 1e-3 <= depth.min() and depth.max() <= 10.0 and depth.std() > 0.3


def test_schedule_is_the_closed_form():
    """10 steps: t = 901, 801, ..., 1; ab_t the product of 1 - beta over
    0..t of the scaled-linear betas; ab_prev that of t - 100, and ab[0] at
    the last step."""
    root = np.linspace(math.sqrt(0.00085), math.sqrt(0.012), 1000)
    ab = np.cumprod(1.0 - root ** 2)
    steps = marigold.ddim_schedule(10)
    assert [t for t, _, _ in steps] == list(range(901, 0, -100))
    for t, ab_t, ab_prev in steps:
        assert ab_t == pytest.approx(ab[t], rel=1e-5)
        assert ab_prev == pytest.approx(ab[t - 100] if t > 100 else ab[0], rel=1e-5)
    assert steps[-1][2] == pytest.approx(1 - 0.00085, rel=1e-6)
    assert marigold.processing_size(480, 640, 768) == (576, 768)


def sin_cos_swapped(t, dim, device):
    emb = REAL_TIMESTEP_EMBEDDING(t, dim, device)
    return torch.cat([emb[:, dim // 2:], emb[:, :dim // 2]], 1)


def v_read_as_epsilon(z, v, ab_t, ab_prev):
    x0 = (z - (1.0 - ab_t) ** 0.5 * v) / ab_t ** 0.5
    return ab_prev ** 0.5 * x0 + (1.0 - ab_prev) ** 0.5 * v


def skips_reversed(h, skip):
    return torch.cat([skip, h], 1)


def no_cross_attention(self, x, context):
    x = x + self.attn1(self.norm1(x))
    return x + self.ff(self.norm3(x))


def encode_unscaled(self, x):
    moments = self.vae.quant_conv(self.vae.encoder(x))
    return moments[:, :moments.shape[1] // 2].float()


def last_alpha_one(steps):
    *head, (t, ab_t, _) = REAL_DDIM_SCHEDULE(steps)
    return (*head, (t, ab_t, 1.0))


def bilinear_upsample(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


# Each planted fault: (object, attribute, replacement).
FAULTS = {
    "sin/cos swapped": (marigold, "timestep_embedding", sin_cos_swapped),
    "v read as epsilon": (marigold, "ddim_step", v_read_as_epsilon),
    "skips reversed": (marigold, "skip_cat", skips_reversed),
    "cross-attention skipped": (marigold.TransformerBlock, "forward", no_cross_attention),
    "latent scale left out": (marigold.MarigoldModel, "encode", encode_unscaled),
    "last ab_prev one": (marigold, "ddim_schedule", last_alpha_one),
    "upsampling bilinear": (marigold, "upsample2x", bilinear_upsample),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_depart_from_reference(weights, image, reference_depth, monkeypatch,
                                              fault):
    """Each planted fault moves the depth beyond the tolerance above: a port
    with it fails the test before."""
    monkeypatch.setattr(*FAULTS[fault])
    got = depth_of(models(weights)[1], image)
    assert (got - reference_depth).abs().max() > 10 * TOL["atol"]


def test_noise_is_drawn_once_from_the_seed(weights, image):
    """The noise of a latent shape is the CPU generator's draw from
    ``noise_seed``, made at the first forward and reused; another seed
    serves another depth."""
    _, port = models(weights)
    first = depth_of(port, image)
    (key, (noise, *temb)), = port._constants.items()
    want = torch.randn((2, 4, 16, 24), generator=torch.Generator().manual_seed(3))
    assert torch.equal(noise, want) and len(temb) == 2
    assert torch.equal(depth_of(port, image), first) and len(port._constants) == 1
    port.noise_seed = 4
    assert not torch.allclose(depth_of(port, image), first)


def test_refuses_a_frame_that_does_not_halve(weights):
    _, port = models(weights)
    with pytest.raises(ValueError, match="halve cleanly"):
        depth_of(port, torch.zeros(1, 3, 15, 24))


def test_forward_padded_leaves_the_frame(weights):
    """``PAD_MULTIPLE`` 1: a 30x45 frame goes in as it is (processed at 32x48)."""
    _, port = models(weights)
    x = torch.rand(1, 3, 30, 45, generator=torch.Generator().manual_seed(2)) * 2 - 1
    focal = torch.ones(1)
    with torch.no_grad():
        padded = predict.forward_padded(port, x, focal)
        direct = port(x, focal)
    assert len(padded) == 1 and padded[0].shape == (1, 1, 30, 45)
    assert torch.equal(padded[0], direct[0])


def test_normalization_is_symmetric():
    cfg = Config(encoder="marigold_v1_0", dataset="nyu", max_depth=10.0)
    assert cfg.resolved_normalization == "symmetric"
    assert Config(encoder="dav2_vitl").resolved_normalization == "imagenet"
    assert cfg.replace(normalization="imagenet").resolved_normalization == "imagenet"


@pytest.fixture
def nyu_frames(tmp_path):
    """Three synthetic NYU frames of 60x90 (processed at 32x48)."""
    scene = tmp_path / "data" / "kitchen_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(5)
    lines = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (60, 90, 3), dtype=np.uint8)).save(
            scene / f"rgb_{i:05d}.jpg")
        Image.fromarray(rng.integers(500, 9000, (60, 90), dtype=np.uint16)).save(
            scene / f"sync_depth_{i:05d}.png")
        lines.append(f"kitchen_0001/rgb_{i:05d}.jpg kitchen_0001/sync_depth_{i:05d}.png 518.8579")
    (tmp_path / "data" / "files.txt").write_text("\n".join(lines) + "\n")
    return tmp_path / "data"


def test_served_everywhere_and_not_trained(nyu_frames, tmp_path, monkeypatch):
    """The tiny widths under ``marigold_v1_0``: ``cli.test`` dumps their
    depth (``--save_lpg`` refused), ``cli.sequence`` writes the depth png
    alone, ``cli.live3d``'s ``depth_fn``, ``tools.bench``'s ``depth_map``
    and online eval serve them; ``cli.train`` and ``TrainState`` refuse
    them, and there is no TF graph."""
    monkeypatch.setitem(marigold.VERSIONS, "marigold_v1_0", TINY)
    monkeypatch.chdir(tmp_path)
    cfg = Config(encoder="marigold_v1_0", dataset="nyu", max_depth=10.0)
    argv = ["--encoder", "marigold_v1_0", "--dataset", "nyu", "--max_depth", "10",
            "--device", "cpu"]
    test_argv = argv + ["--data_path", str(nyu_frames), "--filenames_file",
                        str(nyu_frames / "files.txt"), "--eval_batch_size", "2",
                        "--model_name", "tiny"]
    with pytest.raises(ValueError, match="save_lpg"):
        cli_test.main(test_argv + ["--save_lpg"])
    assert cli_test.main(test_argv) == 0
    names = sorted(os.listdir(tmp_path / "result_tiny" / "raw"))
    assert names == [f"kitchen_0001_rgb_{i:05d}.png" for i in range(3)]
    for name in names:
        a = np.asarray(Image.open(tmp_path / "result_tiny" / "raw" / name))
        assert a.dtype == np.uint16 and a.shape == (60, 90) and a.max() <= 10000

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(6)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (60, 90, 3), dtype=np.uint8)).save(
            frames / f"frame_{i}.jpg")
    assert cli_sequence.main(argv + ["--image_dir", str(frames), "--out_dir",
                                     str(tmp_path / "seq")]) == 0
    assert sorted(os.listdir(tmp_path / "seq")) == ["frame_0_depth.png", "frame_1_depth.png"]

    depth = live3d.make_depth_fn(cfg, "cpu")(rng.integers(0, 255, (70, 100, 3), dtype=np.uint8))
    assert depth.shape == (64, 96) and np.isfinite(depth).all()

    model, bcfg = bench.load_form("plain", "marigold_v1_0", torch.device("cpu"))
    image = torch.rand(1, 3, H, W, generator=torch.Generator().manual_seed(1)) * 2 - 1
    depth = bench.depth_map(model, bcfg, image, torch.ones(1), torch.device("cpu"))
    assert depth.shape == (1, 1, H, W) and bool(torch.isfinite(depth).all())

    ecfg = cfg.replace(data_path_eval=str(nyu_frames), gt_path_eval=str(nyu_frames),
                       filenames_file_eval=str(nyu_frames / "files.txt"), eval_batch_size=2)
    measures = run_online_eval(create_model(ecfg), ecfg, verbose=False)
    assert measures.shape == (9,) and np.isfinite(measures).all()

    with pytest.raises(ValueError, match="served, not trained"):
        cli_train.main(argv)
    with pytest.raises(ValueError, match="served, not trained"):
        TrainState(create_model(cfg), None)
    with pytest.raises(ValueError, match="TF graph"):
        create_model(cfg.replace(model_flavor="tf"))


def test_reference_copies_agree():
    """The tests' reference and the benchmark's compute the same: their code
    is the same line for line, the module docstrings apart."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    codes = []
    for path in ("tests/marigold_reference.py", "benchmark/reference/marigold.py"):
        with open(os.path.join(root, path)) as f:
            codes.append(f.read().split('"""', 2)[2])
    assert codes[0] == codes[1]


def test_profile_names_group_norm():
    """``tools/profile_forward.py`` puts PyTorch's GroupNorm kernels under
    their own kind, apart from LayerNorm and the elementwise kernels."""
    from bts_tpu_torch.tools import profile_forward

    for name in ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(long, "
                 "float, float const*, float*, float*)",
                 "void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float>",
                 "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
                 "namespace)::GroupNormKernelImplInternal<float>(...)::{lambda(float)#1}>"):
        assert profile_forward.kind(name) == "group norm", name
    assert profile_forward.kind("layer_norm_kernel") == "norm"
    assert profile_forward.kind("void at::native::vectorized_elementwise_kernel<4, "
                                "at::native::CUDAFunctor_add<float>>") == "elementwise"
