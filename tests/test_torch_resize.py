"""``ops/resize`` on the CPU: the plain version against ``F.interpolate``
bit for bit at every case the models use (the corner rules, a size or an
integer factor, NCHW and channels-last, float32 and bfloat16 in and out);
the kernel's float32 scales and program shapes at the models' calls; the
dtype and the number of the resizes of the tiny Depth Anything and NeWCRFs
under autocast and without it; the launch counter's registration; and
planted faults in the resize moving the tiny Depth Anything's depth."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bts_tpu_torch import ops
from bts_tpu_torch.models import depth_anything, newcrfs
from bts_tpu_torch.ops import resize
from test_torch_depth_anything import TINY as DAV2_TINY
from test_torch_depth_anything import TOL, depth_of, models
from test_torch_depth_anything import image, reference_depth, weights  # noqa: F401 (fixtures)
from test_torch_newcrfs import TINY as NEWCRFS_TINY

from torch_threads import one_thread  # noqa: F401 (fixture)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (C, Wo, channels-last) of each resize of a batch-8 forward: Depth Anything
# at KITTI (the head's four fusion levels and output_conv1's map, the depth
# back to 352x1216), NeWCRFs at NYU (the PSP's four to 15x20, DispHead x4).
CALLS = [(256, 128, True), (256, 256, True), (256, 512, True), (256, 1024, True),
         (128, 1792, True), (1, 1216, False), (512, 20, False), (1, 640, False)]


def resize_case(kind, h, w):
    """(size, F.interpolate's resize keywords) of a case."""
    if kind == "size":
        return (2 * h + 1, 3 * w - 2), dict(size=(2 * h + 1, 3 * w - 2))
    factor = int(kind[1:])
    return (factor * h, factor * w), dict(scale_factor=factor)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("kind", ["size", "x2", "x4"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("in_dtype", list(DTYPES))
@pytest.mark.parametrize("out_dtype", list(DTYPES))
def test_plain_is_f_interpolate(align_corners, kind, layout, in_dtype, out_dtype):
    """``F.interpolate`` of the float32 input, cast to the output's dtype,
    bit for bit, in x's memory format; on the CPU ``bilinear`` is the plain
    version, so the float32 CPU forward is unchanged."""
    h, w = 5, 7
    x = torch.randn(2, 8, h, w, generator=torch.Generator().manual_seed(h * w))
    x = x.to(DTYPES[in_dtype])
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    x = x.contiguous(memory_format=fmt)
    size, keywords = resize_case(kind, h, w)
    out = DTYPES[out_dtype]
    got = resize.bilinear_plain(x, size, align_corners, out)
    want = F.interpolate(x.float(), **keywords, mode="bilinear",
                         align_corners=align_corners).to(out)
    assert got.shape == (2, 8, *size) and got.dtype == out
    assert got.is_contiguous(memory_format=fmt)
    assert torch.equal(got, want)
    assert torch.equal(resize.bilinear(x, size, align_corners, out), got)


def test_plain_ignores_autocast():
    x = torch.randn(1, 4, 6, 6, generator=torch.Generator().manual_seed(1))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = resize.bilinear(x, (12, 12), True, torch.float32)
    assert torch.equal(got, F.interpolate(x, (12, 12), mode="bilinear", align_corners=True))


@pytest.mark.parametrize("fault", ["float16 in", "float16 out", "3-D map", "empty size",
                                   "kernel on the CPU"])
def test_refused(fault):
    x, size, out = torch.randn(1, 2, 4, 4), (8, 8), torch.float32
    call, error = resize.bilinear, ValueError
    if fault == "float16 in":
        x, error = x.half(), TypeError
    elif fault == "float16 out":
        out, error = torch.float16, TypeError
    elif fault == "3-D map":
        x = x[0]
    elif fault == "empty size":
        size = (0, 8)
    else:
        call = resize.bilinear_triton
    with pytest.raises(error):
        call(x, size, True, out)


def test_source_scales_are_pytorchs():
    """float32 ratios of the sizes: (n_in - 1) / (n_out - 1) with the
    corners aligned (0 for one output), n_in / n_out without, which is
    ``1 / scale_factor`` at an integer factor."""
    assert resize.source_scale(19, 37, True) == 0.5
    assert resize.source_scale(518, 352, True) == float(np.float32(517) / np.float32(351))
    assert resize.source_scale(5, 1, True) == 0.0
    assert resize.source_scale(120, 480, False) == 0.25
    assert resize.source_scale(6, 15, False) == float(np.float32(0.4))
    for n_in, n_out, ac in ((37, 74, True), (296, 518, True), (3, 15, False)):
        scale = resize.source_scale(n_in, n_out, ac)
        assert float(np.float32(scale)) == scale


@pytest.mark.parametrize("c, wo, channels_last", CALLS)
def test_program_shapes(c, wo, channels_last):
    """Powers of two; about ``PROGRAM``'s elements a program (fewer only
    where a channels-last row is narrower); every channel of a map of up to
    256 in one channels-last program; a row of up to 128 columns in one
    program of the other layout."""
    elements = resize.PROGRAM[0]
    block_m, block_n = resize.program_shape(c, wo, channels_last)
    for n in (block_m, block_n):
        assert n >= 1 and n & (n - 1) == 0
    assert block_m * block_n <= elements
    if channels_last:
        assert block_n >= min(c, resize.MAX_BLOCK_C)
        assert block_m * block_n == elements or block_m >= wo
    else:
        assert block_n >= min(wo, resize.MAX_BLOCK_W) and block_m * block_n == elements


def resizes(model, image, **autocast):
    """(out_dtype asked, output dtype) of each resize over one forward."""
    seen = []
    real = resize.bilinear_plain

    def recording(x, size, align_corners, out_dtype):
        y = real(x, size, align_corners, out_dtype)
        seen.append((out_dtype, y.dtype))
        return y

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(resize, "bilinear_plain", recording)
        with torch.no_grad(), torch.autocast("cpu", **autocast):
            depth = model(image, torch.full((image.shape[0],), 518.8579))[-1]
    assert depth.dtype == torch.float32 and torch.isfinite(depth).all()
    return seen


def test_site_dtypes():
    """Under bf16 autocast Depth Anything's five head resizes write bf16
    (a convolution reads each) and its depth resize float32; NeWCRFs's four
    PSP resizes and DispHead's write float32. Without autocast every resize
    writes float32. 6 and 5 a forward."""
    gen = torch.Generator().manual_seed(25)
    dav2 = depth_anything.init_weights(
        depth_anything.DepthAnythingV2Model(80.0, **DAV2_TINY).eval(), gen)
    crfs = newcrfs.init_weights(newcrfs.NeWCRFsModel(10.0, **NEWCRFS_TINY).eval(), gen)
    bf16, f32 = torch.bfloat16, torch.float32
    for model, frame, want in (
            (dav2, torch.randn(1, 3, 48, 160, generator=gen), [bf16] * 5 + [f32]),
            (crfs, torch.randn(1, 3, 64, 96, generator=gen), [f32] * 5)):
        assert resizes(model, frame, dtype=bf16) == [(d, d) for d in want]
        assert resizes(model, frame, enabled=False) == [(f32, f32)] * len(want)


def test_kernel_launches_are_counted_by_replays():
    assert ops.LAUNCH_COUNTERS[f"{resize.__name__}.LAUNCHES"] == (resize, "LAUNCHES")


@pytest.mark.parametrize("fault", ["align_corners flipped", "one pixel off in size"])
def test_planted_faults_move_the_depth(weights, image, reference_depth, monkeypatch,  # noqa: F811
                                       fault):
    """A plain version with the corner rule flipped, or resizing to one
    pixel more in each direction and cropping back (a kernel that read the
    scale off by a pixel), moves the tiny Depth Anything's depth past the
    gate that ``test_torch_depth_anything`` holds the port to."""
    real = resize.bilinear_plain

    def mutated(x, size, align_corners, out_dtype):
        if fault == "align_corners flipped":
            return real(x, size, not align_corners, out_dtype)
        h, w = size
        return real(x, (h + 1, w + 1), align_corners, out_dtype)[:, :, :h, :w]

    _, port = models(weights)
    torch.testing.assert_close(depth_of(port, image), reference_depth, **TOL)
    monkeypatch.setattr(resize, "bilinear_plain", mutated)
    got = depth_of(port, image)
    assert (got - reference_depth).abs().max() > 10 * TOL["atol"]
