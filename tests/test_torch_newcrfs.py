"""NeWCRFs (``--encoder large07``) on the CPU at a tiny size (Swin embed 32,
depths 2/2/2/2, heads 1/2/4/8, CRF dims 64/128/256/512 so that each level
projects the encoder's map as ``large07``'s do, head dim 32, a 64-channel
PSP, 64x96 frames: token maps of 16x24 down to 2x3, so every block pads and
the shifted ones mask), held to the plain float32 reference
(``tests/newcrfs_reference.py``) on seeded weights; the window attention's
plain version against an einsum; a checkpoint in upstream's layout through
``load_weights``; ``cli.test`` with a one-output model; a version added to
``VERSIONS`` alone served by every serving path; training refused."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import newcrfs_reference
from bts_tpu_torch import ops
from bts_tpu_torch.apps import live3d
from bts_tpu_torch.cli import sequence as cli_sequence
from bts_tpu_torch.cli import test as cli_test
from bts_tpu_torch.cli import train as cli_train
from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.online import run_online_eval
from bts_tpu_torch.models import FAMILIES, check_encoder, create_model, model_class, newcrfs
from bts_tpu_torch.models.convert import load_weights
from bts_tpu_torch.models.encoders import swin
from bts_tpu_torch.ops import window_attention as wa
from bts_tpu_torch.tools import bench
from bts_tpu_torch.training.state import TrainState

from torch_threads import one_thread  # noqa: F401 (fixture)

TINY = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
            crf_dims=(64, 128, 256, 512), crf_heads=(2, 4, 8, 16), psp_channels=64, psp_groups=32)
REFERENCE = {
    "max_depth": 10.0,
    "backbone": {"embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8],
                 "window_size": 7, "mlp_ratio": 4.0, "patch_size": 4},
    "decoder": {"pool_scales": [1, 2, 3, 6], "channels": 64, "ppm_groups": 32,
                "crf_dims": [64, 128, 256, 512], "crf_heads": [2, 4, 8, 16],
                "v_dims": [32, 64, 128, 64], "crf_window": 7, "crf_depth": 2},
}
H, W = 64, 96
LEVELS = ("backbone", "decoder", "crf3", "crf2", "crf1", "crf0")
# Both sides are float32 on the CPU and compute the same equations in
# another order (the scale on the scores or on q, the bias added before or
# after, PixelShuffle on other strides): measured gaps are about 4e-6, so
# 1e-4 leaves 25x room, and each mutation below moves the depth by far more.
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    """The reference's state dict with seeded weights away from init:
    Xavier-scale matrices, norms and biases off identity, bias tables of
    std 0.2, BatchNorm statistics drawn."""
    ref = newcrfs_reference.NeWCRFs(REFERENCE)
    gen = torch.Generator().manual_seed(20)
    state = {}
    for k, v in ref.state_dict().items():
        if k.endswith("relative_position_index") or k.endswith("num_batches_tracked"):
            state[k] = v
        elif k.endswith("relative_position_bias_table"):
            state[k] = 0.2 * torch.randn(v.shape, generator=gen)
        elif k.endswith("running_var"):
            state[k] = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() >= 2:
            fan = v.shape[0] + v.shape[1] * (v[0, 0].numel() if v.dim() > 2 else 1)
            state[k] = torch.randn(v.shape, generator=gen) * (2.0 / fan) ** 0.5
        else:
            base = 1.0 if k.endswith("weight") and "running" not in k else 0.0
            state[k] = base + 0.1 * torch.randn(v.shape, generator=gen)
    return state


@pytest.fixture(scope="module")
def image():
    return torch.randn(2, 3, H, W, generator=torch.Generator().manual_seed(0))


def models(state):
    ref = newcrfs_reference.NeWCRFs(REFERENCE).eval()
    ref.load_state_dict(state, strict=True)
    port = newcrfs.NeWCRFsModel(10.0, **TINY).eval()
    port.load_state_dict(state, strict=True)
    return ref, port


def outputs(model, x):
    """Each level's output and the depth map."""
    got = {}
    hooks = [model.get_submodule(n).register_forward_hook(
        lambda m, i, o, n=n: got.__setitem__(n, o)) for n in LEVELS]
    with torch.no_grad():
        out = model(x, torch.full((x.shape[0],), 518.8579))
    for h in hooks:
        h.remove()
    got["depth"] = out[-1] if isinstance(out, tuple) else out
    return got


def test_state_dict_names_are_the_references():
    ref = newcrfs_reference.NeWCRFs(REFERENCE).state_dict()
    port = newcrfs.NeWCRFsModel(10.0, **TINY).state_dict()
    assert list(port) == list(ref)
    assert all(port[k].shape == ref[k].shape for k in ref)
    # The published version's names too, checked on the meta device.
    with torch.device("meta"):
        big = newcrfs.NeWCRFsModel(10.0, **newcrfs.VERSIONS["large07"])
        config = dict(REFERENCE, backbone=dict(REFERENCE["backbone"], embed_dim=192,
                                               depths=[2, 2, 18, 2], num_heads=[6, 12, 24, 48]),
                      decoder=dict(REFERENCE["decoder"], channels=512, ppm_groups=256,
                                   crf_dims=[128, 256, 512, 1024], crf_heads=[4, 8, 16, 32],
                                   v_dims=[64, 128, 256, 512]))
        big_ref = newcrfs_reference.NeWCRFs(config)
    assert {k: v.shape for k, v in big.state_dict().items()} == {
        k: v.shape for k, v in big_ref.state_dict().items()}
    assert sum(p.numel() for p in big.parameters()) == 270_444_877


def test_depth_and_levels_match_reference(weights, image):
    ref, port = models(weights)
    want, got = outputs(ref, image), outputs(port, image)
    for name in LEVELS:
        for w, g in zip(*(v if isinstance(v, (list, tuple)) else [v] for v in (want[name],
                                                                              got[name]))):
            torch.testing.assert_close(g, w, **TOL, msg=name)
    depth = got["depth"]
    assert depth.shape == (2, 1, H, W) and depth.dtype == torch.float32
    torch.testing.assert_close(depth, want["depth"], **TOL)
    assert 0 < depth.min() and depth.max() < 10.0


@pytest.mark.parametrize("mutation", ["mask dropped", "bias dropped", "V from x",
                                      "pad keys zero"])
def test_mutations_depart_from_reference(weights, image, monkeypatch, mutation):
    """Each part of the attention that the equations name moves the depth
    beyond the tolerance above: a port without it fails the test before.
    "pad keys zero": padded tokens' K and V loaded as zeros instead of what
    the Linear makes of a zero row (its bias), which the weights' non-zero
    biases tell apart."""
    ref, port = models(weights)
    want = outputs(ref, image)["depth"]
    real_mask, real_attention = swin.shift_mask, wa.window_attention
    if mutation == "mask dropped":
        def fake_mask(*a):
            return torch.zeros_like(real_mask(*a))

        monkeypatch.setattr(swin, "shift_mask", fake_mask)
        monkeypatch.setattr(newcrfs, "shift_mask", fake_mask)
    else:
        def fake_attention(q, k, v, table, index, mask, scale, window, shift, k_pad, v_pad):
            if mutation == "bias dropped":
                table = torch.zeros_like(table)
            elif mutation == "pad keys zero":
                k_pad = v_pad = None
            else:
                v, v_pad = k, k_pad
            return real_attention(q, k, v, table, index, mask, scale, window, shift, k_pad,
                                  v_pad)

        monkeypatch.setattr(swin, "window_attention", fake_attention)
        monkeypatch.setattr(newcrfs, "window_attention", fake_attention)
        if mutation == "V from x":  # only the CRF levels take V from elsewhere
            monkeypatch.setattr(swin, "window_attention", real_attention)
    got = outputs(port, image)["depth"]
    assert (got - want).abs().max() > 10 * TOL["atol"]


def einsum_attention(q, k, v, table, index, mask, scale):
    """The window attention written out with einsum over (w, n, h, d)."""
    windows, n, heads, _ = q.shape
    s = torch.einsum("wihd,wjhd->whij", q.double(), k.double()) * scale
    s = s + table.double()[index].permute(2, 0, 1)[None]
    if mask is not None:
        s = s + mask.double().repeat(windows // mask.shape[0], 1, 1)[:, None]
    return torch.einsum("whij,wjhd->wihd", s.softmax(-1), v.double()).reshape(windows, n, -1)


def to_windows(t, window, shift):
    """The copies the grid form does without: (B, h, w, ...) padded with
    zeros at the bottom and right to window multiples, rolled by (-shift,
    -shift), cut into windows (B * nW, N, ...)."""
    b, h, w = t.shape[:3]
    hp, wp = wa.padded_grid(h, w, window)
    full = t.new_zeros((b, hp, wp, *t.shape[3:]))
    full[:, :h, :w] = t
    full = torch.roll(full, shifts=(-shift, -shift), dims=(1, 2))
    full = full.view(b, hp // window, window, wp // window, window, -1).transpose(2, 3)
    return full.reshape(b * (hp // window) * (wp // window), window * window, *t.shape[3:])


def from_windows(o, b, h, w, window, shift):
    """``to_windows`` undone: windows (B * nW, N, C) back to the rolled-back,
    cropped grid (B, h * w, C)."""
    hp, wp = wa.padded_grid(h, w, window)
    full = o.view(b, hp // window, wp // window, window, window, -1).transpose(2, 3)
    full = torch.roll(full.reshape(b, hp, wp, -1), shifts=(shift, shift), dims=(1, 2))
    return full[:, :h, :w].reshape(b, h * w, -1)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_plain_matches_einsum(masked):
    gen = torch.Generator().manual_seed(3)
    b, h, w, heads, d = 2, 14, 21, 3, 32
    qkv = torch.randn(b, h, w, 3, heads, d, generator=gen)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]  # as Swin hands them
    table = torch.randn(169, heads, generator=gen)
    index = swin.relative_position_index(7)
    shift, mask = (3, swin.shift_mask(h, w, 7, 3, "cpu")) if masked else (0, None)
    assert mask is None or mask.shape == (6, 49, 49)
    got = wa.window_attention(q, k, v, table, index, mask, d ** -0.5, 7, shift, None, None)
    want = einsum_attention(*(to_windows(t, 7, shift) for t in (q, k, v)), table, index, mask,
                            d ** -0.5)
    want = from_windows(want, b, h, w, 7, shift)
    assert got.shape == (b, h * w, heads * d) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    low = wa.window_attention(*(t.bfloat16() for t in (q, k, v)), table, index, mask, d ** -0.5,
                              7, shift, None, None)
    assert low.dtype == torch.bfloat16
    torch.testing.assert_close(low.double(), want, rtol=0.05, atol=0.05)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_triton(q, k, v, table, index, mask, d ** -0.5, 7, shift, None, None)


@pytest.mark.parametrize("pads", ["swin", "crf"])
@pytest.mark.parametrize("grid", [(10, 13), (14, 21), (16, 24)])
@pytest.mark.parametrize("shift", [0, 3])
def test_grid_form_matches_padded_windows(pads, grid, shift):
    """The grid form against the chain of copies it replaces: the normed
    tokens padded with zeros, through the Linear, rolled, cut into windows,
    ``window_attention_reference``, put back, rolled back, cropped. Swin's
    pad rows are its qkv bias's K and V; the CRF's K is its qk bias's and
    its V (the prediction, which no Linear makes) zero. Float32 on the CPU,
    the biases random and far from zero."""
    gen = torch.Generator().manual_seed(sum(grid) + shift)
    (h, w), b, heads, d = grid, 2, 2, 32
    c = heads * d
    linear = torch.nn.Linear(c, (3 if pads == "swin" else 2) * c)
    with torch.no_grad():
        linear.weight.copy_(torch.randn(linear.weight.shape, generator=gen) * c ** -0.5)
        linear.bias.copy_(torch.randn(linear.bias.shape, generator=gen))
    x = torch.randn(b, h, w, c, generator=gen)
    v_grid = torch.randn(b, h, w, heads, d, generator=gen)
    table = torch.randn(169, heads, generator=gen)
    index = swin.relative_position_index(7)
    hp, wp = wa.padded_grid(h, w, 7)
    mask = swin.shift_mask(hp, wp, 7, shift, "cpu") if shift else None
    with torch.no_grad():
        proj = linear(x).view(b, h, w, -1, heads, d)
        bias = linear.bias.view(-1, c)
        if pads == "swin":
            q, k, v, k_pad, v_pad = proj[..., 0, :, :], proj[..., 1, :, :], proj[..., 2, :, :], \
                bias[1], bias[2]
        else:
            q, k, v, k_pad, v_pad = proj[..., 0, :, :], proj[..., 1, :, :], v_grid, bias[1], None
        got = wa.window_attention(q, k, v, table, index, mask, d ** -0.5, 7, shift, k_pad,
                                  v_pad)
        # The old chain: pad x with zeros, the Linear on every padded token.
        windows = linear(to_windows(x, 7, shift)).view(-1, 49, proj.shape[3], heads, d)
        v_windows = windows[:, :, 2] if pads == "swin" else to_windows(v_grid, 7, shift)
        want = wa.window_attention_reference(windows[:, :, 0], windows[:, :, 1], v_windows,
                                             table, index, mask, d ** -0.5)
        want = from_windows(want, b, h, w, 7, shift)
    assert got.shape == (b, h * w, c)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_shift_mask_is_swins():
    for h, w in ((2, 3), (16, 24), (7, 14)):
        want = newcrfs_reference.attention_mask(h, w, 7, 3, "cpu")
        hp, wp = -(-h // 7) * 7, -(-w // 7) * 7
        assert torch.equal(swin.shift_mask(hp, wp, 7, 3, "cpu"), want)


def test_kernel_launches_are_counted_by_replays():
    assert ops.LAUNCH_COUNTERS[f"{wa.__name__}.LAUNCHES"] == (wa, "LAUNCHES")


def test_upstream_checkpoint_loads(weights, image, tmp_path):
    """A save in upstream's layout: {"model": state_dict} with
    DataParallel's ``module.`` prefix, through ``load_weights``."""
    path = tmp_path / "newcrfs.ckpt"
    torch.save({"model": {f"module.{k}": v for k, v in weights.items()}, "optimizer": {}},
               path)
    port = newcrfs.NeWCRFsModel(10.0, **TINY).eval()
    port.load_state_dict(load_weights(str(path), port, Config(encoder="large07")), strict=True)
    _, want = models(weights)
    torch.testing.assert_close(outputs(port, image)["depth"], outputs(want, image)["depth"],
                               rtol=0, atol=0)


@pytest.fixture
def nyu_frames(tmp_path):
    """Three synthetic NYU frames of 60x90 (padded to 64x96 and cropped back)."""
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


def test_cli_test_dumps_large07(nyu_frames, tmp_path, monkeypatch):
    """``cli.test --encoder large07`` through ``run_predictions`` (the tiny
    widths under the version's name): depth pngs from a model with one
    output, and ``--save_lpg`` refused before the model is built."""
    monkeypatch.setitem(newcrfs.VERSIONS, "large07", TINY)
    monkeypatch.chdir(tmp_path)
    argv = ["--encoder", "large07", "--dataset", "nyu", "--max_depth", "10",
            "--data_path", str(nyu_frames), "--filenames_file", str(nyu_frames / "files.txt"),
            "--eval_batch_size", "2", "--model_name", "tiny", "--device", "cpu"]
    with pytest.raises(ValueError, match="save_lpg"):
        cli_test.main(argv + ["--save_lpg"])
    assert cli_test.main(argv) == 0
    names = sorted(os.listdir(tmp_path / "result_tiny" / "raw"))
    assert names == [f"kitchen_0001_rgb_{i:05d}.png" for i in range(3)]
    model = create_model(Config(encoder="large07", max_depth=10.0)).eval()
    x = torch.from_numpy(np.zeros((1, 60, 90, 3), np.float32)).permute(0, 3, 1, 2)
    assert isinstance(model, newcrfs.NeWCRFsModel) and len(model(
        torch.nn.functional.pad(x, (0, 6, 0, 4)), torch.ones(1))) == 1
    for name in names:
        a = np.asarray(Image.open(tmp_path / "result_tiny" / "raw" / name))
        assert a.dtype == np.uint16 and a.shape == (60, 90) and 0 < a.min() and a.max() < 10000


def test_training_is_refused(monkeypatch):
    """The one check of ``TRAINS``: at ``cli.train``'s start and in every
    train step's state."""
    monkeypatch.setitem(newcrfs.VERSIONS, "large07", TINY)
    cfg = Config(encoder="large07")
    with pytest.raises(ValueError, match="served, not trained"):
        cli_train.main(["--encoder", "large07", "--device", "cpu"])
    with pytest.raises(ValueError, match="served, not trained"):
        TrainState(create_model(cfg), None)
    with pytest.raises(ValueError, match="TF graph"):
        create_model(cfg.replace(model_flavor="tf"))


@pytest.mark.parametrize("name", [n for names, _, _ in FAMILIES for n in sorted(names)])
def test_every_registered_name_keeps_the_contract(name):
    """Each name of the zoo is accepted, and its class (built at no size)
    declares its outputs, the depth last, and whether it trains."""
    check_encoder(name)
    cls = model_class(name)
    assert cls.OUTPUTS[-1] == "depth" and len(set(cls.OUTPUTS)) == len(cls.OUTPUTS)
    assert isinstance(cls.TRAINS, bool)


def test_a_version_added_to_versions_serves_everywhere(nyu_frames, tmp_path, monkeypatch):
    """The tiny widths under a new name in ``newcrfs.VERSIONS``, and nothing
    else: ``cli.test`` dumps its depth, ``cli.sequence`` writes its depth png
    alone, ``cli.live3d``'s ``depth_fn``, ``tools.bench``'s ``depth_map`` and
    online eval serve it; ``cli.train`` and ``TrainState`` refuse it."""
    monkeypatch.setitem(newcrfs.VERSIONS, "tiny_newcrfs", TINY)
    monkeypatch.chdir(tmp_path)
    cfg = Config(encoder="tiny_newcrfs", dataset="nyu", max_depth=10.0)
    argv = ["--encoder", "tiny_newcrfs", "--dataset", "nyu", "--max_depth", "10",
            "--device", "cpu"]
    assert cli_test.main(argv + ["--data_path", str(nyu_frames), "--filenames_file",
                                 str(nyu_frames / "files.txt"), "--eval_batch_size", "2",
                                 "--model_name", "tiny"]) == 0
    assert len(os.listdir(tmp_path / "result_tiny" / "raw")) == 3

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

    model, bcfg = bench.load_form("plain", "tiny_newcrfs", torch.device("cpu"))
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
