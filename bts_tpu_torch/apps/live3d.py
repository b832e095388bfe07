"""Live 3D point-cloud demo, webcam -> depth -> point cloud:
``bts_tpu/apps/live3d.py`` in PyTorch.

Reference: pytorch/bts_live_3d.py / tensorflow/bts_live_3d.py, a
PySide2/PyOpenGL app: webcam capture -> undistort to NYU intrinsics
(f=518.8579) -> normalize -> center-crop -> model -> depth; unproject via
precomputed pixel rays, hide depth edges via a Sobel-magnitude mask (>0.3),
render a GL_POINTS cloud.

The numeric stages (undistortion maps, ray unprojection, the Sobel edge
mask, the software renderer, the headless loop) are copies of
``bts_tpu``'s numpy functions; the depth comes from the port's model at
batch 1 on the card (``make_depth_fn``). The GUI shell (Qt/OpenGL/webcam) is
optional and gated on its imports, as in ``bts_tpu``. The reference PT demo
normalizes with caffe-style stats even though the model trained with
torchvision stats (pytorch/bts_live_3d.py:266-269, a reference bug); the
normalization here is the checkpoint's, ``cfg.resolved_normalization``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bts_tpu_torch.config import Config

NYU_FOCAL = 518.8579


def undistort_maps(
    camera_matrix: np.ndarray,
    dist_coeffs: np.ndarray,
    new_camera_matrix: np.ndarray,
    size: Tuple[int, int] = (640, 480),
) -> Tuple[np.ndarray, np.ndarray]:
    """Plumb-bob undistortion remap (numpy equivalent of the reference's
    cv2.initUndistortRectifyMap, pytorch/bts_live_3d.py:76-94): for each
    pixel of the rectified NYU-intrinsics image, the source (x, y) in the
    raw webcam frame. dist_coeffs = (k1, k2, p1, p2, k3).
    """
    w, h = size
    fx_n, fy_n = new_camera_matrix[0, 0], new_camera_matrix[1, 1]
    cx_n, cy_n = new_camera_matrix[0, 2], new_camera_matrix[1, 2]
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    k1, k2, p1, p2, k3 = [float(c) for c in dist_coeffs[:5]]

    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = (fx * x_d + cx).astype(np.float32)
    map_y = (fy * y_d + cy).astype(np.float32)
    return map_x, map_y


def remap_nearest(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Apply an undistortion remap with nearest sampling (numpy)."""
    h, w = image.shape[:2]
    xi = np.clip(np.round(map_x).astype(np.int64), 0, w - 1)
    yi = np.clip(np.round(map_y).astype(np.int64), 0, h - 1)
    return image[yi, xi]


def pixel_rays(height: int, width: int, focal: float = NYU_FOCAL) -> np.ndarray:
    """Per-pixel unprojection rays (x/f, y/f, 1) with the principal point at
    the image center (pytorch/bts_live_3d.py:414-421)."""
    xs = (np.arange(width, dtype=np.float32) - (width - 1) / 2.0) / focal
    ys = (np.arange(height, dtype=np.float32) - (height - 1) / 2.0) / focal
    xx, yy = np.meshgrid(xs, ys)
    return np.stack([xx, yy, np.ones_like(xx)], axis=-1)  # (H, W, 3)


def unproject(depth: np.ndarray, rays: np.ndarray) -> np.ndarray:
    """depth (H,W) + rays (H,W,3) -> world points (H,W,3)."""
    return rays * depth[..., None]


def sobel_edge_mask(depth: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """Mask points across depth discontinuities
    (pytorch/bts_live_3d.py:133-136,426): True = keep."""
    d = np.asarray(depth, np.float32)
    pad = np.pad(d, 1, mode="edge")
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = kx.T
    gx = np.zeros_like(d)
    gy = np.zeros_like(d)
    for i in range(3):
        for j in range(3):
            sub = pad[i : i + d.shape[0], j : j + d.shape[1]]
            gx += kx[i, j] * sub
            gy += ky[i, j] * sub
    mag = np.sqrt(gx**2 + gy**2)
    return mag <= threshold


def center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = (h - height) // 2
    left = (w - width) // 2
    return img[top : top + height, left : left + width]


def make_depth_fn(cfg: Config, device="cuda", model=None):
    """Returns fn(rgb uint8 HxWx3) -> depth (H', W') float32: the frame
    center-cropped to multiples of 32, normalized by
    ``cfg.resolved_normalization``, through the model at batch 1 on
    ``device`` under ``inference_mode`` (bf16 autocast under
    ``--compute_dtype bfloat16``). The model is ``load_model(cfg)`` unless
    one is given."""
    from bts_tpu_torch.apps.predict import compute_context, load_model
    from bts_tpu_torch.data.transforms import normalize_image

    device = torch.device(device)
    if model is None:
        model = load_model(cfg, device)
    focal = torch.tensor([NYU_FOCAL], dtype=torch.float32, device=device)
    # Resolved once, not per frame. The reference PT demo normalizes
    # caffe-style even though PT training used torchvision stats
    # (pytorch/bts_live_3d.py:266-269), a reference bug not reproduced: the
    # style follows the checkpoint via cfg.
    normalization = cfg.resolved_normalization

    def depth_fn(rgb: np.ndarray) -> np.ndarray:
        h = rgb.shape[0] - rgb.shape[0] % 32
        w = rgb.shape[1] - rgb.shape[1] % 32
        img = center_crop(rgb, h, w).astype(np.float32) / 255.0
        img = normalize_image(img, normalization).astype(np.float32)
        image = torch.from_numpy(img).permute(2, 0, 1)[None].to(device)
        with torch.inference_mode(), compute_context(cfg, device):
            depth = model(image, focal)[-1]
        return depth[0, 0].float().cpu().numpy()

    return depth_fn


def frame_to_cloud(
    rgb: np.ndarray,
    depth_fn,
    edge_threshold: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """One demo step: rgb frame -> (points Nx3, colors Nx3 in [0,1])."""
    depth = depth_fn(rgb)
    h, w = depth.shape
    rays = pixel_rays(h, w)
    points = unproject(depth, rays)
    keep = sobel_edge_mask(depth, edge_threshold)
    colors = center_crop(rgb, h, w).astype(np.float32) / 255.0
    return points[keep], colors[keep]


def _rotation(azimuth_deg: float, elevation_deg: float) -> np.ndarray:
    """World rotation for an orbiting camera (the headless stand-in for the
    reference's trackball MVP, pytorch/bts_live_3d.py:455-484)."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    ry = np.array(
        [
            [np.cos(az), 0, np.sin(az)],
            [0, 1, 0],
            [-np.sin(az), 0, np.cos(az)],
        ]
    )
    rx = np.array(
        [
            [1, 0, 0],
            [0, np.cos(el), -np.sin(el)],
            [0, np.sin(el), np.cos(el)],
        ]
    )
    return rx @ ry


def render_cloud(
    points: np.ndarray,
    colors: np.ndarray,
    height: int = 480,
    width: int = 640,
    azimuth_deg: float = 0.0,
    elevation_deg: float = 0.0,
    distance: float = None,
    focal: float = NYU_FOCAL,
    splat: int = 2,
    background: float = 0.0,
) -> np.ndarray:
    """Offscreen point-cloud render -> (H, W, 3) uint8.

    Software equivalent of the reference's GL_POINTS pass
    (pytorch/bts_live_3d.py:383-484): orbit the camera about the cloud
    centroid, pinhole-project, and resolve occlusion with a painter's sort
    (points drawn far-to-near, near wins — exact for 1px point splats).
    """
    img = np.full((height, width, 3), background, np.float32)
    if points.size == 0:
        return (img * 255).astype(np.uint8)
    center = points.mean(axis=0)
    p = (points - center) @ _rotation(azimuth_deg, elevation_deg).T
    if distance is None:
        distance = 2.0 * float(np.abs(p).max())
    p = p + np.array([0.0, 0.0, distance])

    z = p[:, 2]
    front = z > 1e-3
    p, c, z = p[front], colors[front], z[front]
    u = np.round(focal * p[:, 0] / z + (width - 1) / 2.0).astype(np.int64)
    v = np.round(focal * p[:, 1] / z + (height - 1) / 2.0).astype(np.int64)
    inside = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, c, z = u[inside], v[inside], c[inside], z[inside]
    order = np.argsort(-z)  # far first; near overwrites
    u, v, c = u[order], v[order], c[order]
    for du in range(splat):
        for dv in range(splat):
            uu = np.clip(u + du, 0, width - 1)
            vv = np.clip(v + dv, 0, height - 1)
            img[vv, uu] = c
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def run_headless(
    cfg: Config,
    image_dir: str,
    out_dir: str = "",
    views=((0.0, 0.0), (-25.0, -10.0), (25.0, -10.0)),
    edge_threshold: float = 0.3,
    device="cuda",
) -> int:
    """Directory-of-frames -> depth -> point cloud -> rendered PNGs.

    The headless twin of the reference's live GL loop (capability E10):
    each input frame produces one render per requested (azimuth, elevation)
    view in out_dir. Returns the number of frames processed.
    """
    import glob
    import os

    from PIL import Image

    out_dir = out_dir or os.path.join(image_dir, "cloud")
    os.makedirs(out_dir, exist_ok=True)
    depth_fn = make_depth_fn(cfg, device)
    frames = sorted(
        glob.glob(os.path.join(image_dir, "*.png"))
        + glob.glob(os.path.join(image_dir, "*.jpg"))
    )
    n = 0
    for path in frames:
        rgb = np.asarray(Image.open(path).convert("RGB"))
        points, colors = frame_to_cloud(rgb, depth_fn, edge_threshold)
        stem = os.path.splitext(os.path.basename(path))[0]
        for vi, (az, el) in enumerate(views):
            img = render_cloud(
                points,
                colors,
                height=rgb.shape[0],
                width=rgb.shape[1],
                azimuth_deg=az,
                elevation_deg=el,
            )
            Image.fromarray(img).save(
                os.path.join(out_dir, f"{stem}_cloud_{vi}.png")
            )
        n += 1
        print(f"[{n}/{len(frames)}] {stem}: {points.shape[0]} points")
    return n


def main(cfg: Config, device="cuda") -> int:  # pragma: no cover - requires GUI stack
    """Launch the interactive viewer.

    Prefers the GL point-cloud viewer (reference
    pytorch/bts_live_3d.py:383-484; needs cv2 + Qt + PyOpenGL); falls back
    to a cv2 depth-colormap loop when only cv2 is present; headless-only
    installs get a pointer to run_headless.
    """
    try:
        import cv2  # noqa: F401
    except ImportError:
        print(
            "live3d GUI requires opencv/Qt/OpenGL which are not installed; "
            "the numeric pipeline (make_depth_fn/frame_to_cloud) is available "
            "headless."
        )
        return 1
    try:
        from bts_tpu_torch.apps.live3d_gl import run_gl

        return run_gl(cfg, device=device)
    except ImportError:
        print("Qt/PyOpenGL not installed; showing 2D depth colormap instead.")
    depth_fn = make_depth_fn(cfg, device)
    cap = cv2.VideoCapture(0)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        # The colorized depth alone (no undistortion: supply the camera's
        # calibration to undistort_maps for that).
        d = depth_fn(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        vis = (np.clip(d / cfg.max_depth, 0, 1) * 255).astype(np.uint8)
        cv2.imshow("bts depth", cv2.applyColorMap(vis, cv2.COLORMAP_MAGMA))
        if cv2.waitKey(1) & 0xFF == ord("q"):
            break
    cap.release()
    return 0
