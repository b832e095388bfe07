"""Interactive GL point-cloud viewer for the live 3D demo:
``bts_tpu/apps/live3d_gl.py`` for the port.

Reference: pytorch/bts_live_3d.py:300-484 (QGLWidget + GLSL shaders +
GL_POINTS VBOs + trackball MVP) / tensorflow/bts_live_3d.py (same shell).

All viewer math (perspective / lookAt / axis-angle rotation, the trackball
state machine, and the fixed-length vertex-buffer update with edge hiding
and scene centering) is pure numpy, a copy of ``bts_tpu``'s, held against it
by tests/test_torch_apps.py. The GL shell (``GLPointCloudWidget``,
``run_gl``) is gated on its imports (PySide2/PySide6 + PyOpenGL) exactly as
``bts_tpu``'s is; its depth comes from the port's ``make_depth_fn`` on the
card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bts_tpu_torch.apps.live3d import NYU_FOCAL, center_crop, make_depth_fn, sobel_edge_mask

# ---------------------------------------------------------------------------
# Matrix math (numpy twins of the reference's glm calls,
# pytorch/bts_live_3d.py:455-463). All matrices are standard
# row-major math convention: apply as M @ column_vector. Upload to GL with
# transpose=True (see GLPointCloudWidget.paintGL).
# ---------------------------------------------------------------------------


def perspective(fovy_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm.perspective(45, w/h, 0.01, 100) equivalent."""
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up) -> np.ndarray:
    """glm.lookAt equivalent."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def rotate(m: np.ndarray, angle_rad: float, axis) -> np.ndarray:
    """glm.rotate(M, angle, axis) equivalent (post-multiplies M)."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    ic = 1.0 - c
    r = np.eye(4, dtype=np.float32)
    r[:3, :3] = np.array(
        [
            [c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s],
            [y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s],
            [z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic],
        ]
    )
    return (m @ r).astype(np.float32)


# ---------------------------------------------------------------------------
# Trackball state machine (pytorch/bts_live_3d.py:302-380).
# ---------------------------------------------------------------------------


@dataclass
class Trackball:
    """Mouse/wheel-driven orbit state, reference units (1/160 rad ticks).

    Initial pose and the MVP recipe match the reference exactly
    (xRot=5040, yRot=40, zoomLevel=9; drawObject at
    pytorch/bts_live_3d.py:455-463).
    """

    x_rot: float = 5040.0
    y_rot: float = 40.0
    z_rot: float = 0.0
    zoom_level: float = 9.0

    def drag(self, dx_px: float, dy_px: float, button: str = "left") -> None:
        """Mouse drag: left orbits (x,y), right rolls (x,z). The reference
        negates horizontal motion (mouseMoveEvent: dx = -(x - last.x))."""
        dx = -dx_px
        dy = dy_px
        if button == "left":
            self.x_rot += dy
            self.y_rot += dx
        elif button == "right":
            self.x_rot += dy
            self.z_rot += dx

    def wheel(self, delta: float) -> None:
        """Wheel zoom: delta in Qt eighth-degrees, 15 deg per step."""
        self.zoom_level += (delta / 8.0) / 15.0

    def mvp(self, width: int, height: int) -> np.ndarray:
        """proj * view * model, the reference's drawObject camera."""
        proj = perspective(45.0, width / height, 0.01, 100.0)
        view = look_at(
            eye=(0.0, 0.0, -0.4 * (self.zoom_level / 10.0)),
            center=(0.0, -0.075, 0.0),
            up=(0.0, -1.0, 0.0),
        )
        model = np.eye(4, dtype=np.float32)
        model = rotate(model, self.x_rot / 160.0, (1, 0, 0))
        model = rotate(model, self.y_rot / 160.0, (0, 1, 0))
        model = rotate(model, self.z_rot / 160.0, (0, 0, 1))
        return (proj @ view @ model).astype(np.float32)


# ---------------------------------------------------------------------------
# Vertex-buffer update (pytorch/bts_live_3d.py:425-453).
# ---------------------------------------------------------------------------

SCENE_SHIFT = np.array([0.0, -0.06, -0.3], np.float32)
EDGE_FAR = 1e6  # reference hides depth edges by pushing them to z=1e6


def cloud_vertex_data(
    depth: np.ndarray,
    rgb: np.ndarray,
    focal: float = NYU_FOCAL,
    edge_threshold: float = 0.3,
) -> tuple[np.ndarray, np.ndarray]:
    """(H,W) depth + (H,W,3) uint8 rgb -> fixed-length (N,3) f32 pos/col.

    Matches the reference updateRGBD/posFromDepth: edge pixels keep their
    slot but get depth 1e6 (so the VBO length never changes and set_array
    can update in place), rays use the principal point at W/2, H/2
    (worldCoords, pytorch/bts_live_3d.py:414-421), and the whole scene is
    shifted by (0, -0.06, -0.3).
    """
    h, w = depth.shape
    d = np.asarray(depth, np.float32).copy()
    d[~sobel_edge_mask(d, edge_threshold)] = EDGE_FAR
    xs = (np.arange(w, dtype=np.float32) - w / 2.0) / focal
    ys = (np.arange(h, dtype=np.float32) - h / 2.0) / focal
    xx, yy = np.meshgrid(xs, ys)
    pos = np.stack([xx * d, yy * d, d], axis=-1).reshape(-1, 3)
    pos = pos + SCENE_SHIFT
    col = (
        np.asarray(rgb, np.float32).reshape(-1, 3) / 255.0
    ).astype(np.float32)
    return pos.astype(np.float32), col


# ---------------------------------------------------------------------------
# GL shell (import-gated; absent GUI deps degrade to ImportError at call).
# ---------------------------------------------------------------------------

VERTEX_SHADER_SRC = """#version 330
layout(location = 0) in vec3 position;
layout(location = 1) in vec3 color;
uniform mat4 mvp;
out vec4 frag_color;
void main() {
    gl_Position = mvp * vec4(position, 1.0);
    frag_color = vec4(color, 1.0);
}"""

FRAGMENT_SHADER_SRC = """#version 330
in vec4 frag_color;
out vec4 out_color;
void main() { out_color = frag_color; }"""


def _import_gui():
    """Import Qt (PySide6 preferred, PySide2 fallback) + PyOpenGL."""
    try:
        from PySide6 import QtCore, QtWidgets  # type: ignore
        from PySide6.QtOpenGLWidgets import QOpenGLWidget  # type: ignore
    except ImportError:
        from PySide2 import QtCore, QtWidgets  # type: ignore
        from PySide2.QtWidgets import QOpenGLWidget  # type: ignore
    from OpenGL import GL  # type: ignore
    from OpenGL.arrays import vbo  # type: ignore
    from OpenGL.GL import shaders  # type: ignore

    return QtCore, QtWidgets, QOpenGLWidget, GL, vbo, shaders


def make_widget_class():
    """Build GLPointCloudWidget against whichever GUI stack is installed.

    Raises ImportError when no GUI stack is present (callers gate on this —
    the cv2 fallback loop in apps/live3d.py then takes over).
    """
    QtCore, QtWidgets, QOpenGLWidget, GL, vbo, shaders = _import_gui()

    class GLPointCloudWidget(QOpenGLWidget):
        """GL_POINTS cloud with the reference's shaders and trackball."""

        def __init__(self, parent=None, width: int = 640, height: int = 480):
            super().__init__(parent)
            self.trackball = Trackball()
            self._last = None
            self.pos = np.zeros((width * height, 3), np.float32)
            self.col = np.zeros((width * height, 3), np.float32)
            self.pos_vbo = None
            self.col_vbo = None
            self.program = None

        # -- data path ---------------------------------------------------
        def update_rgbd(self, rgb: np.ndarray, depth: np.ndarray) -> None:
            self.pos, self.col = cloud_vertex_data(depth, rgb)
            self.update()

        # -- GL lifecycle ------------------------------------------------
        def initializeGL(self):
            GL.glEnable(GL.GL_DEPTH_TEST)
            vs = shaders.compileShader(VERTEX_SHADER_SRC, GL.GL_VERTEX_SHADER)
            fs = shaders.compileShader(
                FRAGMENT_SHADER_SRC, GL.GL_FRAGMENT_SHADER
            )
            self.program = shaders.compileProgram(vs, fs)
            self.mvp_loc = GL.glGetUniformLocation(self.program, "mvp")
            self.pos_vbo = vbo.VBO(
                data=self.pos,
                usage=GL.GL_DYNAMIC_DRAW,
                target=GL.GL_ARRAY_BUFFER,
            )
            self.col_vbo = vbo.VBO(
                data=self.col,
                usage=GL.GL_DYNAMIC_DRAW,
                target=GL.GL_ARRAY_BUFFER,
            )

        def paintGL(self):
            GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
            shaders.glUseProgram(self.program)
            mvp = self.trackball.mvp(max(self.width(), 1), max(self.height(), 1))
            # Our matrices are row-major math convention; GL wants
            # column-major, hence transpose=True.
            GL.glUniformMatrix4fv(self.mvp_loc, 1, True, mvp)
            self.pos_vbo.set_array(self.pos)
            self.col_vbo.set_array(self.col)
            GL.glPointSize(2)
            self.pos_vbo.bind()
            GL.glEnableVertexAttribArray(0)
            GL.glVertexAttribPointer(0, 3, GL.GL_FLOAT, GL.GL_FALSE, 0, None)
            self.col_vbo.bind()
            GL.glEnableVertexAttribArray(1)
            GL.glVertexAttribPointer(1, 3, GL.GL_FLOAT, GL.GL_FALSE, 0, None)
            GL.glDrawArrays(GL.GL_POINTS, 0, self.pos.shape[0])

        # -- trackball events --------------------------------------------
        def mousePressEvent(self, event):
            self._last = event.pos()

        def mouseMoveEvent(self, event):
            if self._last is None:
                self._last = event.pos()
                return
            dx = event.x() - self._last.x()
            dy = event.y() - self._last.y()
            buttons = event.buttons()
            if buttons & QtCore.Qt.LeftButton:
                self.trackball.drag(dx, dy, "left")
            elif buttons & QtCore.Qt.RightButton:
                self.trackball.drag(dx, dy, "right")
            self._last = event.pos()
            self.update()

        def wheelEvent(self, event):
            self.trackball.wheel(event.angleDelta().y())
            event.accept()
            self.update()

    return GLPointCloudWidget


def run_gl(cfg, depth_fn=None, camera_index: int = 0, device="cuda") -> int:
    """Webcam -> depth -> interactive GL point cloud (reference main loop,
    pytorch/bts_live_3d.py:196-297). Requires cv2 + Qt + PyOpenGL."""
    import cv2  # noqa: F401 — gate first, cheapest import

    QtCore, QtWidgets, _, _, _, _ = _import_gui()

    widget_cls = make_widget_class()
    if depth_fn is None:
        depth_fn = make_depth_fn(cfg, device)

    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    widget = widget_cls()
    widget.setWindowTitle("bts live 3D")
    widget.resize(640, 480)
    widget.show()

    cap = cv2.VideoCapture(camera_index)

    def tick():
        ok, frame = cap.read()
        if not ok:
            return
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        depth = depth_fn(rgb)
        h, w = depth.shape
        widget.update_rgbd(center_crop(rgb, h, w), depth)

    timer = QtCore.QTimer()
    timer.timeout.connect(tick)
    timer.start(10)  # reference QTimer(10ms)
    rc = app.exec_() if hasattr(app, "exec_") else app.exec()
    cap.release()
    return int(rc)
