"""Depth Anything V2 (``--encoder dav2_vitl``) on the CPU at a tiny size (a
ViT of embed 128, 2 heads of 64, depth 4 tapped at every block, a 5x5
position table, input size 70; a head of 32 features over 16/32/64/64
channels; 48x160 frames, resized to 70x238: 5x17 patches, 86 tokens),
held to the plain float32 reference (``tests/depth_anything_reference.py``)
on seeded weights away from init; the resize rule at KITTI's and NYU's
frames; planted faults that each move the depth past the test's gate; a
checkpoint under upstream's names through ``load_weights``;
``forward_padded`` leaving the frame as it is; the tiny widths served by
every serving path and refused by training."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import depth_anything_reference
from bts_tpu_torch.apps import live3d, predict
from bts_tpu_torch.cli import sequence as cli_sequence
from bts_tpu_torch.cli import test as cli_test
from bts_tpu_torch.cli import train as cli_train
from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.online import run_online_eval
from bts_tpu_torch.models import create_model, depth_anything
from bts_tpu_torch.models.convert import load_weights
from bts_tpu_torch.models.encoders import vit
from bts_tpu_torch.ops import resize
from bts_tpu_torch.tools import bench
from bts_tpu_torch.training.state import TrainState

from torch_threads import one_thread  # noqa: F401 (fixture)

TINY = dict(embed_dim=128, depth=4, num_heads=2, pos_grid=5, taps=(0, 1, 2, 3), features=32,
            out_channels=(16, 32, 64, 64), input_size=70)
REFERENCE = {
    "max_depth": 80.0, "input_size": 70,
    "vit": {"embed_dim": 128, "depth": 4, "num_heads": 2, "mlp_ratio": 4, "patch_size": 14,
            "pos_grid": 5, "interpolate_offset": 0.1, "layer_norm_eps": 1e-6,
            "taps": [0, 1, 2, 3]},
    "dpt": {"features": 32, "out_channels": [16, 32, 64, 64], "head_hidden": 32},
}
H, W = 48, 160
# Both sides are float32 on the CPU and compute the same equations, some in
# another order (the attention's scale on q or on the scores, the tokens'
# layout around the head's reshape): 1e-4 leaves room, and each planted
# fault below moves the depth by far more.
TOL = dict(rtol=1e-4, atol=1e-4)


def to_port(state):
    """The reference's names as the program's: ``ls<i>.weight`` -> ``ls<i>.gamma``."""
    return {k.replace(".ls1.weight", ".ls1.gamma").replace(".ls2.weight", ".ls2.gamma"): v
            for k, v in state.items()}


@pytest.fixture(scope="module")
def weights():
    """The reference's state dict away from init: Xavier-scale matrices,
    norms and biases off identity, LayerScale in [0.2, 1], the class token
    and the position table of std 1 (the patch tokens' scale), so that
    dropping or misplacing any of them shows."""
    ref = depth_anything_reference.DepthAnythingV2(REFERENCE)
    gen = torch.Generator().manual_seed(24)
    state = {}
    for k, v in ref.state_dict().items():
        if k.endswith(("cls_token", "pos_embed", "mask_token")):
            state[k] = torch.randn(v.shape, generator=gen)
        elif ".ls" in k:
            state[k] = 0.2 + 0.8 * torch.rand(v.shape, generator=gen)
        elif v.dim() >= 2:
            fan = v.shape[0] + v.shape[1] * v[0, 0].numel()
            state[k] = torch.randn(v.shape, generator=gen) * (2.0 / fan) ** 0.5
        else:
            base = 1.0 if k.endswith("weight") else 0.0
            state[k] = base + 0.1 * torch.randn(v.shape, generator=gen)
    return state


@pytest.fixture(scope="module")
def image():
    return torch.randn(2, 3, H, W, generator=torch.Generator().manual_seed(0))


def models(state):
    ref = depth_anything_reference.DepthAnythingV2(REFERENCE).eval()
    ref.load_state_dict(state, strict=True)
    port = depth_anything.DepthAnythingV2Model(80.0, **TINY).eval()
    port.load_state_dict(to_port(state), strict=True)
    return ref, port


def depth_of(model, x):
    with torch.no_grad():
        out = model(x, torch.full((x.shape[0],), 721.5377))
    return out[-1] if isinstance(out, tuple) else out


@pytest.fixture(scope="module")
def reference_depth(weights, image):
    return depth_of(models(weights)[0], image)


def test_state_dict_names_are_the_references():
    ref = depth_anything_reference.DepthAnythingV2(REFERENCE).state_dict()
    port = depth_anything.DepthAnythingV2Model(80.0, **TINY).state_dict()
    assert list(port) == list(to_port(ref))
    assert all(port[k].shape == v.shape for k, v in to_port(ref).items())
    assert "pretrained.blocks.3.ls2.gamma" in port
    assert "depth_head.scratch.output_conv2.2.weight" in port
    with torch.device("meta"):
        big = depth_anything.DepthAnythingV2Model(80.0, **depth_anything.VERSIONS["dav2_vitl"])
    assert sum(p.numel() for p in big.parameters()) == 335_315_649
    assert sum(p.numel() for p in big.pretrained.parameters()) == 304_368_640


def test_depth_and_taps_match_reference(weights, image, reference_depth):
    ref, port = models(weights)
    x = torch.nn.functional.interpolate(image, (70, 238), mode="bicubic", align_corners=False)
    with torch.no_grad():
        want = ref.pretrained.get_intermediate_layers(x, REFERENCE["vit"]["taps"])
        got = port.pretrained(x)
    assert len(got) == 4 and got[0].shape == (2, 5 * 17, 128)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    depth = depth_of(port, image)
    assert depth.shape == (2, 1, H, W) and depth.dtype == torch.float32
    torch.testing.assert_close(depth, reference_depth, **TOL)
    assert 0 < depth.min() and depth.max() < 80.0 and depth.std() > 1.0


def test_resize_rule():
    for (h, w), want in (((352, 1216), (518, 1792)), ((480, 640), (518, 686)),
                         ((48, 160), (70, 238)), ((518, 518), (518, 518)), ((45, 150), (70, 238))):
        size = 70 if h < 100 else 518
        assert depth_anything.model_input(h, w, size) == want
        assert depth_anything_reference.resized(h, w, size, 14) == want
    assert (4737 - 1) == (518 // 14) * (1792 // 14)


def fake_no_scale(real):
    return lambda q, k, v, scale: real(q, k, v, 1.0)


def fake_cls_not_a_key(real):
    def attention(q, k, v, scale):
        b, n, heads, d = q.shape
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k[:, 1:].float()) * scale
        o = torch.einsum("bhnm,bmhd->bnhd", s.softmax(-1), v[:, 1:].float())
        return o.reshape(b, n, heads * d).to(q.dtype)
    return attention


def pos_by_size(self, h, w):
    pos, g = self.pos_embed.float(), self.pos_grid
    grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = torch.nn.functional.interpolate(grid, size=(h, w), mode="bicubic",
                                           align_corners=False)
    return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)


def taps_before_their_block(self, x):
    h, w = x.shape[-2] // vit.PATCH, x.shape[-1] // vit.PATCH
    x = self.patch_embed(x)
    x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x.float()], 1)
    x = x + self.position_embedding(h, w)
    outs = []
    for i, blk in enumerate(self.blocks):
        if i in self.taps:
            outs.append(self.norm(x)[:, 1:])
        x = blk(x)
    return outs


def corners_off(real):
    """An ``ops/resize`` resize with ``align_corners`` flipped: every
    bilinear resize of the model (each at ``align_corners=True``) at
    ``align_corners=False``."""

    def resize(x, size, align_corners, out_dtype):
        return real(x, size, not align_corners, out_dtype)

    return resize


@pytest.mark.parametrize("fault", ["no attention scale", "pos-embed by size",
                                   "LayerScale dropped", "class token not a key",
                                   "taps off by one", "head resize corners off"])
def test_planted_faults_depart_from_reference(weights, image, reference_depth, monkeypatch,
                                              fault):
    """Each planted fault moves the depth beyond the tolerance above: a port
    with it fails the test before."""
    if fault == "no attention scale":
        monkeypatch.setattr(vit, "global_attention", fake_no_scale(vit.global_attention))
    elif fault == "pos-embed by size":
        monkeypatch.setattr(vit.DinoVisionTransformer, "position_embedding", pos_by_size)
    elif fault == "LayerScale dropped":
        monkeypatch.setattr(vit.LayerScale, "forward", lambda self, x: x)
    elif fault == "class token not a key":
        monkeypatch.setattr(vit, "global_attention", fake_cls_not_a_key(vit.global_attention))
    elif fault == "taps off by one":
        monkeypatch.setattr(vit.DinoVisionTransformer, "forward", taps_before_their_block)
    else:
        monkeypatch.setattr(resize, "bilinear_plain", corners_off(resize.bilinear_plain))
    got = depth_of(models(weights)[1], image)
    assert (got - reference_depth).abs().max() > 10 * TOL["atol"]


def test_upstream_checkpoint_loads(weights, image, reference_depth, tmp_path):
    """A bare state dict under upstream's names, with DataParallel's
    ``module.`` prefix, through ``load_weights`` and ``strict=True``."""
    path = tmp_path / "depth_anything_v2_metric_vkitti_vitl.pth"
    torch.save({f"module.{k}": v for k, v in to_port(weights).items()}, path)
    port = depth_anything.DepthAnythingV2Model(80.0, **TINY).eval()
    port.load_state_dict(load_weights(str(path), port, Config(encoder="dav2_vitl")), strict=True)
    torch.testing.assert_close(depth_of(port, image), reference_depth, **TOL)


def test_forward_padded_leaves_the_frame(weights):
    """``PAD_MULTIPLE`` 1: a 45x150 frame goes in as it is."""
    _, port = models(weights)
    x = torch.randn(1, 3, 45, 150, generator=torch.Generator().manual_seed(2))
    focal = torch.ones(1)
    with torch.no_grad():
        padded = predict.forward_padded(port, x, focal)
        direct = port(x, focal)
    assert len(padded) == 1 and padded[0].shape == (1, 1, 45, 150)
    assert torch.equal(padded[0], direct[0])


@pytest.fixture
def nyu_frames(tmp_path):
    """Three synthetic NYU frames of 60x90."""
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
    """The tiny widths under ``dav2_vitl``: ``cli.test`` dumps their depth
    (``--save_lpg`` refused), ``cli.sequence`` writes the depth png alone,
    ``cli.live3d``'s ``depth_fn``, ``tools.bench``'s ``depth_map`` and
    online eval serve them; ``cli.train`` and ``TrainState`` refuse them, and
    there is no TF graph."""
    monkeypatch.setitem(depth_anything.VERSIONS, "dav2_vitl", TINY)
    monkeypatch.chdir(tmp_path)
    cfg = Config(encoder="dav2_vitl", dataset="nyu", max_depth=10.0)
    argv = ["--encoder", "dav2_vitl", "--dataset", "nyu", "--max_depth", "10", "--device", "cpu"]
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
        assert a.dtype == np.uint16 and a.shape == (60, 90) and 0 < a.min() and a.max() < 10000

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

    model, bcfg = bench.load_form("plain", "dav2_vitl", torch.device("cpu"))
    image = torch.randn(1, 3, H, W, generator=torch.Generator().manual_seed(1))
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
