"""The TF graph (``flavor="tf"``) of the port against bts_tpu's on the CPU in
f32, with the same weights: its pieces (slim SAME padding, the align-corners
downsample, the pi/6 plane decode, the TF atrous conv, the SAME stem with BN
eps 1.1e-5), the whole model through the weight bridge, TF checkpoints
(``convert_full_tf``, ``warm_start_from_tf``, the loaders), the flavor and
normalization sniff, and the loop's warm start and resume from a TF prefix
(tests/test_torch_tf_train.py holds the train steps).

Sizes: DenseNet121-BTS at bts_size 256 on 64x96 inputs, as
tests/test_tf_flavor.py. One bts_tpu model (and one jitted forward) per
module, its LPG the plain XLA version (tests/test_torch_lpg.py holds the
Pallas kernel)."""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.models import convert_tf as jconvert_tf
from bts_tpu.models import layers as jlayers
from bts_tpu.models.convert import _flatten, _unflatten
from bts_tpu.models.decoder import AtrousConv as JAtrousConv
from bts_tpu.models.encoders import densenet as jdensenet
from bts_tpu.ops.lpg import decode_plane_eq as jdecode_plane_eq
from bts_tpu_torch.apps.predict import load_model
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts, convert_tf, layers
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.models.decoder import AtrousConv
from bts_tpu_torch.models.encoders import densenet
from bts_tpu_torch.ops.lpg import decode_plane_eq
from bts_tpu_torch.training import checkpoint, optim, state
from bts_tpu_torch.training.loop import warm_start

from test_torch_decoder import randomize_bn

ENC = "densenet121_bts"
NF = 256
H, W = 64, 96
ARCH_ROOT = "model/encoder/densenet121/"
# The whole model against bts_tpu's: test_torch_model.py's tolerance.
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def randomize(params, stats, rng):
    """BN leaves as randomize_bn does, and every conv bias (zeros at init)
    drawn, so that the bias leaves are routed and used."""
    params, stats = randomize_bn(params, stats, rng)
    flat = {path: rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
            if path[-2:] == ("conv", "bias") else leaf
            for path, leaf in _flatten(params).items()}
    return _unflatten(flat), stats


@pytest.fixture(scope="module")
def tf_model():
    """bts_tpu's TF-graph DenseNet121-BTS, seeded variables away from their
    init, and its jitted forward."""
    jm = jbts.BTSModel(encoder_name=ENC, max_depth=10.0, bts_size=NF, flavor="tf",
                       lpg_impl="xla")
    params, stats = jbts.init_model(jm, jax.random.key(0), (1, H, W, 3))
    params, stats = randomize(params, stats, np.random.default_rng(1))

    @jax.jit
    def forward(p, s, x, focal):
        return jm.apply({"params": p, "batch_stats": s}, x, focal)

    return params, stats, forward


def inputs(seed=2, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, H, W, 3)).astype(np.float32)
    return x, np.full((b,), 518.8579, np.float32)


def port_model(**kw):
    return bts.BTSModel(ENC, 10.0, "nyu", NF, flavor="tf", **kw)


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("size,k,s", [(64, 7, 2), (96, 7, 2), (63, 7, 2), (32, 3, 2),
                                      (33, 3, 2), (15, 3, 1)])
def test_same_pads_match_bts_tpu(size, k, s):
    assert layers.same_pads(size, k, s) == jdensenet._same_pads(size, k, s)


@pytest.mark.parametrize("h,w,r", [(16, 24, 4), (32, 40, 2), (8, 8, 4), (64, 96, 4), (60, 80, 2)])
def test_align_corners_downsample_matches_bts_tpu(h, w, r):
    """The indices are bts_tpu's (16 -> 4 picks [0, 5, 10, 15]), and the NCHW
    gather equals bts_tpu's NHWC downsample_nearest_ac exactly."""
    for n_in, n_out in ((h, h // r), (w, w // r)):
        np.testing.assert_array_equal(layers.align_corners_indices(n_in, n_out),
                                      jlayers._align_corners_indices(n_in, n_out))
    assert layers.align_corners_indices(16, 4).tolist() == [0, 5, 10, 15]
    x = np.random.default_rng(3).normal(size=(2, h, w, 3)).astype(np.float32)
    got = layers.downsample_nearest_ac(torch.from_numpy(x).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(nhwc(got), np.asarray(jlayers.downsample_nearest_ac(
        jnp.asarray(x), r)))


@pytest.mark.parametrize("theta_max", [math.pi / 3, math.pi / 6])
def test_decode_plane_eq_matches_bts_tpu(theta_max):
    """The TF graph's pi/6 and the PT graph's pi/3, rtol 1e-6; at pi/6 the
    normal's n3 = cos(theta) stays at or above cos(pi/6)."""
    raw = np.random.default_rng(4).normal(size=(2, 4, 6, 3)).astype(np.float32)
    got = decode_plane_eq(torch.from_numpy(raw), 10.0, theta_max).numpy()
    want = np.asarray(jdecode_plane_eq(jnp.asarray(raw), 10.0, theta_max))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[..., 2].min() >= math.cos(theta_max) - 1e-6


@pytest.mark.parametrize("apply_bn_first,rate", [(True, 6), (False, 3)])
def test_tf_atrous_conv_matches_bts_tpu(apply_bn_first, rate):
    """The TF atrous conv (input padded by the rate before the first BN, also
    with none; biased convs; ELU after the 1x1; inner BN eps 1.1e-5; VALID
    dilated conv) against bts_tpu's AtrousConv(tf_variant=True), every leaf
    random, rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(5)
    cin = 6
    jmod = JAtrousConv(features=8, dilation=rate, apply_bn_first=apply_bn_first,
                       tf_variant=True)
    x = rng.normal(size=(2, 10, 14, cin)).astype(np.float32)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    flat = {k: {p: (rng.uniform(0.5, 1.5, np.shape(v)) if p[-1] == "var"
                    else rng.normal(scale=0.3, size=np.shape(v))).astype(np.float32)
                for p, v in _flatten(jax.tree.map(np.asarray, t)).items()}
            for k, t in variables.items()}
    want = jmod.apply({k: _unflatten(v) for k, v in flat.items()}, jnp.asarray(x))

    mod = AtrousConv(cin, 8, rate, apply_bn_first, tf_variant=True)
    # Named as a decoder site so that the bridge maps it.
    named = state_dict_from_flax({"decoder": {"daspp_6": _unflatten(flat["params"])}},
                                 {"decoder": {"daspp_6": _unflatten(flat["batch_stats"])}})
    mod.load_state_dict({k.removeprefix("decoder.daspp_6."): v for k, v in named.items()},
                        strict=True)
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(64, 96), (63, 95)])
def test_tf_stem_encoder_matches_bts_tpu(h, w):
    """A narrow DenseNet with the TF stem (slim SAME conv and pool, (2, 3)
    and (0, 1) on even sizes) and BN eps 1.1e-5: all five skips against
    bts_tpu's DenseNetEncoder(bn_eps=1.1e-5, tf_stem=True), rtol 1e-4,
    atol 1e-5."""
    rng = np.random.default_rng(6)
    jenc = jdensenet.DenseNetEncoder((2, 2, 2, 2), 8, 16, bn_eps=1.1e-5, tf_stem=True)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    variables = jenc.init(jax.random.key(0), jnp.asarray(x))
    params, stats = randomize_bn(variables["params"], variables["batch_stats"], rng)
    want = jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))

    enc = densenet.DenseNetEncoder((2, 2, 2, 2), 8, 16, bn_eps=1.1e-5, tf_stem=True)
    named = state_dict_from_flax({"encoder": params}, {"encoder": stats})
    enc.load_state_dict({k.removeprefix("encoder."): v for k, v in named.items()}, strict=True)
    assert {m.eps for m in enc.modules() if isinstance(m, torch.nn.BatchNorm2d)} == {1.1e-5}
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_allclose(nhwc(g), np.asarray(wnt), rtol=1e-4, atol=1e-5)


def test_tf_flavor_rejects_non_densenet():
    with pytest.raises(ValueError, match="densenet"):
        bts.BTSModel("resnet50_bts", flavor="tf")
    with pytest.raises(ValueError, match="flavor"):
        bts.BTSModel(ENC, flavor="tpu")


# ------------------------------------------------------------- whole model


@pytest.mark.parametrize("dense_impl,lpg_impl", [("auto", "auto"), ("taps", "auto"),
                                                 ("auto", "ffi")])
def test_tf_model_matches_bts_tpu(tf_model, dense_impl, lpg_impl):
    """bts_tpu's TF-graph tree loads strictly into the port's TF model (the
    bias leaves, reduc1x1's extra conv, the biased conv1/2/3), and the five
    outputs agree at MODEL_TOL: dense layers unfused or through the fused
    layer's plain version; LPG plain or the native CPU kernel."""
    params, stats, forward = tf_model
    x, focal = inputs()
    want = forward(params, stats, jnp.asarray(x), jnp.asarray(focal))
    model = port_model(lpg_impl=lpg_impl)
    model.encoder.dense_impl = dense_impl
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    assert "decoder.reduc1x1.reduc.inter_16_16.0.bias" in model.state_dict()
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(focal))
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_allclose(nhwc(g), np.asarray(wnt), **MODEL_TOL)


# ---------------------------------------------------------- TF checkpoints


def _tf_names(params, stats, nf=NF):
    """(TF name -> shape) of every variable of a TF-graph model, by bts_tpu's
    own mapping (which tests/test_tf_flavor.py pins)."""
    dec_map = jconvert_tf.tf_decoder_name_map(nf)
    out = {}
    for tree in (params, stats):
        for path, leaf in _flatten(tree).items():
            if path[0] == "encoder":
                name = ARCH_ROOT + jconvert_tf._tf_encoder_name(path[1:-2], path[-1])
            else:
                name = "model/decoder/" + dec_map["/".join(path[1:])]
            out[name] = np.shape(leaf)
    return out


def _save_v2(tf, prefix, tensors):
    names = sorted(tensors)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(tensors[n]) for n in names])


@pytest.fixture(scope="module")
def tf_checkpoints(tf_model, tmp_path_factory):
    """A full TF BTS checkpoint written with tf.raw_ops.SaveV2 (random
    tensors under the reference graph's names, plus a global_step and an
    Adam slot), an encoder-only one (plus a variable no model has), and a
    directory holding the full one with a 'checkpoint' state file."""
    tf = pytest.importorskip("tensorflow")
    params, stats, _ = tf_model
    rng = np.random.default_rng(7)
    full = {}
    for name, shape in _tf_names(params, stats).items():
        full[name] = (rng.uniform(0.5, 1.5, shape) if name.endswith("moving_variance")
                      else rng.normal(size=shape) * 0.05).astype(np.float32)
    d = tmp_path_factory.mktemp("tf")
    prefix = str(d / "model")
    _save_v2(tf, prefix, {**full, "global_step": np.int64(777),
                          "model/decoder/Conv/weights/Adam": np.zeros((3, 3, 1024, NF),
                                                                      np.float32)})
    encoder = {n: v for n, v in full.items() if n.startswith(ARCH_ROOT)}
    enc_prefix = str(d / "encoder")
    _save_v2(tf, enc_prefix, {**encoder, "model/encoder/densenet121/logits/weights":
                              np.zeros((4,), np.float32)})
    ckpt_dir = d / "run"
    ckpt_dir.mkdir()
    _save_v2(tf, str(ckpt_dir / "model-5"), full)
    (ckpt_dir / "checkpoint").write_text('model_checkpoint_path: "model-5"\n')
    return prefix, enc_prefix, str(ckpt_dir)


def test_convert_full_tf_matches_bts_tpu(tf_model, tf_checkpoints):
    """The port's convert_full_tf of a SaveV2 checkpoint equals bts_tpu's
    after the bridge, tensor for tensor (HWIO to OIHW), with the same report;
    ``load_model`` serves the prefix (flavor and normalization auto) and
    agrees with bts_tpu's model on bts_tpu's conversion at MODEL_TOL."""
    params, stats, forward = tf_model
    prefix, _, _ = tf_checkpoints
    tf_vars = convert_tf.load_tf_checkpoint(prefix)
    jp, js, jreport = jconvert_tf.convert_full_tf(tf_vars, params, stats, ENC, NF)
    got, report = convert_tf.convert_full_tf(tf_vars, port_model().state_dict(), ENC, NF)
    assert report == jreport
    assert report["skipped_non_model"] == ["global_step", "model/decoder/Conv/weights/Adam"]
    want = state_dict_from_flax(jp, js)
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)

    cfg = Config(encoder=ENC, bts_size=NF, checkpoint_path=prefix)
    assert (cfg.resolved_flavor, cfg.resolved_normalization) == ("tf", "caffe")
    model = load_model(cfg, torch.device("cpu"))
    x, focal = inputs(seed=8)
    with torch.no_grad():
        outs = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(focal))
    for g, wnt in zip(outs, forward(jp, js, jnp.asarray(x), jnp.asarray(focal)), strict=True):
        np.testing.assert_allclose(nhwc(g), np.asarray(wnt), **MODEL_TOL)


def test_convert_full_tf_desync_detection(tf_checkpoints):
    """A missing variable, a variable no model tensor consumes, and a wrong
    width each raise."""
    prefix, _, _ = tf_checkpoints
    tf_vars = convert_tf.load_tf_checkpoint(prefix)
    template = port_model().state_dict()
    broken = dict(tf_vars)
    del broken["model/decoder/Conv_10/weights"]
    with pytest.raises(KeyError, match="not found"):
        convert_tf.convert_full_tf(broken, template, ENC, NF)
    extra = dict(tf_vars)
    extra["model/decoder/Conv_99/weights"] = np.zeros((1, 1, 4, 4), np.float32)
    with pytest.raises(KeyError, match="no model leaf"):
        convert_tf.convert_full_tf(extra, template, ENC, NF)
    with pytest.raises((KeyError, ValueError)):
        convert_tf.convert_full_tf(tf_vars, template, ENC, 512)
    # The PT graph has no biases to take the decoder's.
    with pytest.raises(KeyError):
        convert_tf.convert_full_tf(tf_vars, bts.BTSModel(ENC, bts_size=NF).state_dict(), ENC,
                                   NF)


def test_warm_start_from_tf_matches_bts_tpu(tf_model, tf_checkpoints):
    """An encoder-only TF checkpoint warm-starts the encoder by name, as
    bts_tpu's does (the same variables loaded and left over, the same
    values); the decoder keeps its seeded weights."""
    params, stats, _ = tf_model
    _, enc_prefix, _ = tf_checkpoints
    tf_vars = convert_tf.load_tf_checkpoint(enc_prefix)
    jp, js, jreport = jconvert_tf.warm_start_from_tf(tf_vars, params, stats, ENC)
    template = port_model().state_dict()
    got, report = convert_tf.warm_start_from_tf(tf_vars, template, ENC)
    assert sorted(report["loaded"]) == sorted(jreport["loaded"])
    assert report["unmatched_checkpoint"] == jreport["unmatched_checkpoint"] == [
        "model/encoder/densenet121/logits/weights"]
    assert all(k.startswith("decoder.") for k in report["unmatched_model"])
    want = state_dict_from_flax(jp, js)
    for k, v in got.items():
        if k.startswith("encoder.") and not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
        else:
            assert torch.equal(v, template[k]), k


def test_flavor_and_normalization_sniff(tf_checkpoints, tmp_path, monkeypatch):
    """'auto' resolves 'tf' and caffe for a full TF prefix, a TF checkpoint
    directory, and a port .pth whose decoder convs carry biases; 'pt' and
    imagenet for a PT .pth; an encoder-only TF --pretrained_model keeps the
    PT graph with caffe; an explicit flag wins; the sniff opens the
    checkpoint once per Config; without tensorflow a TF prefix raises."""
    prefix, enc_prefix, ckpt_dir = tf_checkpoints
    tf_pth, pt_pth = str(tmp_path / "tf.pth"), str(tmp_path / "pt.pth")
    torch.save({"model": port_model().state_dict()}, tf_pth)
    torch.save({"model": bts.BTSModel(ENC, bts_size=NF).state_dict()}, pt_pth)
    for kw, want in [
        (dict(checkpoint_path=prefix), ("tf", "caffe")),
        (dict(checkpoint_path=ckpt_dir), ("tf", "caffe")),
        (dict(checkpoint_path=tf_pth), ("tf", "caffe")),
        (dict(pretrained_model=tf_pth), ("tf", "caffe")),
        (dict(checkpoint_path=pt_pth), ("pt", "imagenet")),
        (dict(pretrained_model=enc_prefix), ("pt", "caffe")),
        (dict(checkpoint_path=prefix, model_flavor="pt"), ("pt", "imagenet")),
        (dict(checkpoint_path=prefix, normalization="imagenet"), ("tf", "imagenet")),
        (dict(model_flavor="tf"), ("tf", "caffe")),
        (dict(), ("pt", "imagenet")),
    ]:
        cfg = Config(encoder=ENC, bts_size=NF, **kw)
        assert (cfg.resolved_flavor, cfg.resolved_normalization) == want, kw
        if not any(str(v).endswith(".pth") for v in kw.values()):
            jcfg = JConfig(encoder=ENC, bts_size=NF, **kw)
            assert (jcfg.resolved_flavor, jcfg.resolved_normalization) == want, kw
    assert convert_tf.load_full_tf(ckpt_dir, port_model().state_dict(), ENC, NF)[1] == {}

    calls = []
    real = convert_tf.is_tf_checkpoint
    monkeypatch.setattr(convert_tf, "is_tf_checkpoint", lambda p: calls.append(p) or real(p))
    cfg = Config(encoder=ENC, bts_size=NF, checkpoint_path=prefix)
    assert [cfg.resolved_flavor, cfg.resolved_flavor, cfg.resolved_normalization] == [
        "tf", "tf", "caffe"]
    assert calls == [prefix]
    assert cfg.replace(checkpoint_path="").resolved_flavor == "pt"

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        Config(encoder=ENC, bts_size=NF, checkpoint_path=prefix).resolved_flavor


def test_loop_warm_starts_and_resumes_from_a_tf_prefix(tf_checkpoints):
    """--pretrained_model: a full TF checkpoint loads strictly, an
    encoder-only one warm-starts the encoder; --checkpoint_path: the
    weights and the stored global_step (777), the LR schedule advanced to
    it and fresh optimizer moments."""
    prefix, enc_prefix, _ = tf_checkpoints
    cfg = Config(encoder=ENC, bts_size=NF, model_flavor="tf", pretrained_model=prefix,
                 checkpoint_path=prefix)
    want, meta = convert_tf.load_full_tf(prefix, port_model().state_dict(), ENC, NF)
    assert meta == {"global_step": 777}

    model = bts.create_model(cfg)
    warm_start(model, prefix, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    seeded = bts.create_model(cfg)
    fresh = {k: v.clone() for k, v in seeded.state_dict().items()}
    warm_start(seeded, enc_prefix, cfg)
    for k, v in seeded.state_dict().items():
        assert torch.equal(v, want[k] if k.startswith("encoder.") and "num_batches" not in k
                           else fresh[k]), k

    model = bts.create_model(cfg)
    opt, _ = optim.create_optimizer(cfg, model, 1000)
    st, best = checkpoint.restore_training_start(cfg, state.TrainState(model, opt),
                                                 checkpoint.BestTracker())
    assert st.step == 777
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    retrain = checkpoint.restore_training_start(
        cfg.replace(retrain=True), state.TrainState(bts.create_model(cfg), opt),
        checkpoint.BestTracker())[0]
    assert retrain.step == 0
