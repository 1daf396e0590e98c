"""Live-viewer TCP endpoint — SIBR remote-viewer protocol (a copy of the JAX
package's utils/network_gui.py: sockets and numpy only).

Parity: gaussian_renderer/network_gui.py (85 LoC): a non-blocking listener;
the viewer sends [4-byte LE length][json] camera messages (view /
view-projection matrices with the y/z sign convention flips) and receives
raw RGB bytes followed by [4-byte LE length][verify string].
"""
from __future__ import annotations

import json
import socket
from typing import NamedTuple

import numpy as np


class ViewerCamera(NamedTuple):
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    w2c: np.ndarray        # [4, 4] column-vector convention
    full_proj: np.ndarray  # [4, 4]


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: socket.socket | None = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _recv_exact(self, n: int) -> bytes:
        assert self.conn is not None
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        length = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(length).decode("utf-8"))

    def receive(self):
        """-> (ViewerCamera | None, do_training, keep_alive, scaling_mod)."""
        msg = self.read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        w2c = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        w2c[:, 1] = -w2c[:, 1]
        w2c[:, 2] = -w2c[:, 2]
        full_proj = np.asarray(
            msg["view_projection_matrix"], np.float32
        ).reshape(4, 4)
        full_proj[:, 1] = -full_proj[:, 1]
        cam = ViewerCamera(
            width=width, height=height,
            fovx=msg["fov_x"], fovy=msg["fov_y"],
            znear=msg["z_near"], zfar=msg["z_far"],
            # viewer sends row-vector (transposed) matrices; our convention
            # is column-vector
            w2c=w2c.T, full_proj=full_proj.T,
        )
        return (cam, bool(msg["train"]), bool(msg["keep_alive"]),
                float(msg["scaling_modifier"]))

    def send_image(self, image: np.ndarray | None, verify: str) -> None:
        """image: [H, W, 3] float in [0,1] or None."""
        assert self.conn is not None
        if image is not None:
            payload = (
                np.clip(np.asarray(image), 0, 1) * 255
            ).astype(np.uint8).tobytes()
            self.conn.sendall(payload)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop_connection(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.drop_connection()
        self.listener.close()
