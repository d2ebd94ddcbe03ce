"""Euler-angle fly camera matching the reference's glm conventions.

Replicates ``src/Camera.cpp`` / ``include/Camera.h`` behaviour exactly so that
renders match pixel-for-pixel:

- view = R * T(+position)  -- the translation is NOT negated
  (ref ``src/Camera.cpp:57-65``; SURVEY.md quirk list)
- R = Rx(rx) * Ry(ry) * Rz(rz), angles in degrees (``Camera.cpp:59-62``)
- projection = glm::perspective(radians(fovy), aspect, near, far)
  (``Camera.cpp:27``), fovy default 60, near 0.1, far 10000
- default render target 1024x512 (``Camera.h:55,62``)
- focal_x = width  / (2*tan(radians(fovy)/2))   (``Camera.cpp:181-188``)
  focal_y = height / (2*tan(radians(fovy)/2))   (``Camera.cpp:190-197``)
- getTanFovx/getTanFovy reproduce the reference's degrees-vs-radians quirk
  (``Camera.cpp:199-212``): tan(fovy/2) is evaluated with fovy in DEGREES
  interpreted as radians. The resulting negative value makes the
  min(limx, max(-limx, x)) expression in the preprocess shader act as a wide
  clamp; with the mathematically "correct" positive tan it would degenerate
  (the two quirks cancel -- see SURVEY.md section 7 "known quirks"). Correct
  variants are provided as ``tan_fovx_correct`` / ``tan_fovy_correct``.

Matrices are returned as numpy ``(4, 4)`` float32 arrays in standard
column-vector math convention (apply as ``M @ v``), which is numerically
identical to glm's column-major storage of the same linear maps.
"""

from __future__ import annotations

import math

import numpy as np


def _rot_x(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_y(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def _rot_z(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def perspective(fovy_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspective for a right-handed, [-1, 1] clip-space convention."""
    t = math.tan(fovy_rad / 2.0)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    return p


class Camera:
    """Mutable fly camera with the reference's movement API (``Camera.h:13-66``)."""

    def __init__(self, x: float = 0.0, y: float = 0.0, z: float = 0.0,
                 width: int = 1024, height: int = 512,
                 fovy: float = 60.0, near: float = 0.1, far: float = 10000.0):
        self.position = np.array([x, y, z], dtype=np.float32)
        self.rotation = np.zeros(3, dtype=np.float32)  # degrees, (rx, ry, rz)
        self.fovy = float(fovy)
        self.near = float(near)
        self.far = float(far)
        self.width = int(width)
        self.height = int(height)
        self.rotation_matrix = np.eye(3, dtype=np.float32)
        self.view_matrix = np.eye(4, dtype=np.float32)
        self.update()

    # -- matrices ----------------------------------------------------------

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def update(self) -> None:
        """Recompute rotation and view matrices (ref ``Camera.cpp:57-65``)."""
        r = _rot_x(self.rotation[0]) @ _rot_y(self.rotation[1]) @ _rot_z(self.rotation[2])
        self.rotation_matrix = r.astype(np.float32)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = self.position  # glm::translate with +position (quirk kept)
        v = np.eye(4, dtype=np.float32)
        v[:3, :3] = r
        self.view_matrix = (v @ t).astype(np.float32)

    def get_view_matrix(self) -> np.ndarray:
        return self.view_matrix

    def get_projection_matrix(self) -> np.ndarray:
        return perspective(math.radians(self.fovy), self.aspect, self.near, self.far)

    def get_vp_matrix(self) -> np.ndarray:
        return (self.get_projection_matrix() @ self.view_matrix).astype(np.float32)

    # -- intrinsics --------------------------------------------------------

    def get_focal_x(self) -> float:
        return self.width / (2.0 * math.tan(math.radians(self.fovy) / 2.0))

    def get_focal_y(self) -> float:
        return self.height / (2.0 * math.tan(math.radians(self.fovy) / 2.0))

    def get_tan_fovy(self) -> float:
        # Reference quirk: fovy treated as radians without conversion
        # (Camera.cpp:209). tan(30) for the default fovy=60 is ~ -6.4053.
        return math.tan(self.fovy / 2.0)

    def get_tan_fovx(self) -> float:
        # Reference quirk chain (Camera.cpp:199-206): atan(tan(fovy/2)*aspect)
        # then tan of it == tan(fovy/2)*aspect, with fovy in degrees-as-radians.
        return math.tan(math.atan(math.tan(self.fovy / 2.0) * self.aspect))

    def tan_fovy_correct(self) -> float:
        return math.tan(math.radians(self.fovy) / 2.0)

    def tan_fovx_correct(self) -> float:
        return self.tan_fovy_correct() * self.aspect

    # -- movement (ref Camera.cpp:121-179) ---------------------------------

    def move_forward(self, d: float) -> None:
        # Direction = third row of the rotation matrix (Camera.cpp:124).
        self.position = self.position + self.rotation_matrix[2, :] * d
        self.update()

    def move_backward(self, d: float) -> None:
        self.move_forward(-d)

    def move_left(self, d: float) -> None:
        # Direction = first row of the rotation matrix (Camera.cpp:136).
        self.position = self.position + self.rotation_matrix[0, :] * d
        self.update()

    def move_right(self, d: float) -> None:
        self.move_left(-d)

    def move_up(self, d: float) -> None:
        self.position = self.position + np.array([0.0, d, 0.0], dtype=np.float32)
        self.update()

    def move_down(self, d: float) -> None:
        self.move_up(-d)

    def rotate_right(self, deg: float) -> None:
        self.rotation[1] += deg
        self.update()

    def rotate_left(self, deg: float) -> None:
        self.rotate_right(-deg)

    def rotate_up(self, deg: float) -> None:
        self.rotation[0] += deg
        self.update()

    def rotate_down(self, deg: float) -> None:
        self.rotate_up(-deg)

    # -- setters (Camera.h:40-44) ------------------------------------------

    def set_width_height(self, width: int, height: int) -> None:
        self.width = int(width)
        self.height = int(height)

    def set_position(self, x: float, y: float, z: float) -> None:
        self.position = np.array([x, y, z], dtype=np.float32)
        self.update()

    def set_rotation(self, x: float, y: float, z: float) -> None:
        self.rotation = np.array([x, y, z], dtype=np.float32)
        self.update()

    def set_fovy(self, fovy: float) -> None:
        self.fovy = float(fovy)


def default_camera(width: int = 1024, height: int = 512) -> Camera:
    """The camera pose hard-coded in the reference app (``main.cpp:40-45``)."""
    cam = Camera(5.0, 0.5, -4.0, width=width, height=height)
    cam.rotate_down(20.0)
    cam.rotate_right(40.0)
    cam.update()
    return cam
