"""The port's SIBR live-viewer endpoint (mygauhuman_torch/utils/network_gui.py)
against the JAX package's, over loopback sockets, and `cli.train --gui`
on the port (`--device cpu`) with a viewer connected.

  * the same client messages to both servers: the parsed cameras equal,
    and the bytes each sends back (RGB payload, length, verify string)
    equal, byte for byte;
  * a zero-resolution poll, a disconnect surfaced as ConnectionError, and
    a listener that does not block without a client;
  * `cli.train --gui`: a viewer connects while the loop runs, sends one
    camera and gets back a frame of its own resolution from the port's
    `render_frame` plus the output directory as the verify string: the
    bytes on the wire are that render (through the viewer's camera, with
    the run's MLPs) as 8-bit pixels, exactly.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

from mygauhuman_tpu.utils.network_gui import NetworkGUI as JGUI
from mygauhuman_torch.utils.network_gui import NetworkGUI as TGUI
from test_network_gui import _camera_msg, _free_port, _recv_exact, _send_msg

torch.set_num_threads(1)


def _exchange(gui_cls, msgs, images):
    """Serve `msgs` with `gui_cls`; returns (cameras parsed, bytes received)."""
    port = _free_port()
    gui = gui_cls("127.0.0.1", port)
    try:
        client = socket.create_connection(("127.0.0.1", port), timeout=5)
        assert gui.try_connect()
        cams, received = [], b""
        for msg, img in zip(msgs, images):
            _send_msg(client, msg)
            cams.append(gui.receive())
            gui.send_image(img, "/some/model/dir")
            n = 0 if img is None else img.shape[0] * img.shape[1] * 3
            received += _recv_exact(client, n + 4)
            received += _recv_exact(client, int.from_bytes(received[-4:], "little"))
        client.close()
        with pytest.raises(ConnectionError):
            gui.read()
        gui.drop_connection()
        assert gui.conn is None
    finally:
        gui.close()
    return cams, received


@pytest.mark.parametrize("size", [(8, 6), (20, 20), (33, 17)])
def test_wire_bytes_match_jax(size):
    rng = np.random.RandomState(size[0])
    w, h = size
    msg = _camera_msg(width=w, height=h, keep_alive=bool(w % 2), train=bool(h % 2))
    view = rng.randn(4, 4).astype(np.float32)
    msg["view_matrix"] = view.reshape(-1).tolist()
    msg["view_projection_matrix"] = (view @ rng.randn(4, 4).astype(np.float32)).reshape(-1).tolist()
    msg["scaling_modifier"] = 0.75
    img = rng.rand(h, w, 3).astype(np.float32) * 1.2 - 0.1      # clipped to [0, 1]
    msgs = [msg, _camera_msg(width=0, height=0)]
    images = [img, None]
    tc, tb = _exchange(TGUI, msgs, images)
    jc, jb = _exchange(JGUI, msgs, images)
    assert tb == jb
    assert len(tb) == h * w * 3 + 4 + len("/some/model/dir") + 4 + len("/some/model/dir")
    (tcam, ttrain, tkeep, tmod), (jcam, jtrain, jkeep, jmod) = tc[0], jc[0]
    assert (ttrain, tkeep, tmod) == (jtrain, jkeep, jmod) == (bool(h % 2), bool(w % 2), 0.75)
    for f in tcam._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tcam, f)), np.asarray(getattr(jcam, f)))
    assert tc[1] == jc[1] == (None, None, None, None)


def test_try_connect_does_not_block():
    gui = TGUI("127.0.0.1", _free_port())
    try:
        t0 = time.perf_counter()
        assert gui.try_connect() is False
        assert time.perf_counter() - t0 < 1.0
    finally:
        gui.close()


def test_viewer_during_cli_training(tmp_path, monkeypatch):
    import mygauhuman_torch.render as render_mod
    from mygauhuman_torch.cli.train import main as train_main

    port = _free_port()
    out = str(tmp_path / "exp_gui")
    W = H = 20
    result, err, served = {}, [], []
    orig_render = render_mod.render_frame

    def render_frame(state, camera, *args, **kw):
        out_ = orig_render(state, camera, *args, **kw)
        if camera.width == W and camera.height == H:     # the viewer's frame
            served.append((camera, kw, out_.render))
        return out_

    monkeypatch.setattr(render_mod, "render_frame", render_frame)

    def run():
        try:
            result.update(train_main([
                "--synthetic", "--synthetic_size", "32", "--synthetic_verts", "120",
                "--iterations", "40", "--test_iterations", "40", "--save_iterations", "40",
                "--model_path", out, "--skip_galleries", "--disable_lpips",
                "--gui", "--gui_port", str(port), "--device", "cpu"]))
        except Exception as e:          # surface the thread's failure
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    try:
        client = None
        for _ in range(300):            # wait for the listener
            try:
                client = socket.create_connection(("127.0.0.1", port), timeout=0.2)
                break
            except OSError:
                if not t.is_alive():
                    break
                time.sleep(0.1)
        assert client is not None, (err, result)
        msg = _camera_msg(width=W, height=H, keep_alive=False)
        _send_msg(client, msg)
        client.settimeout(120)
        frame = np.frombuffer(_recv_exact(client, H * W * 3), np.uint8).reshape(H, W, 3)
        vlen = int.from_bytes(_recv_exact(client, 4), "little")
        assert _recv_exact(client, vlen).decode() == out
        client.close()
    finally:
        t.join(timeout=600)
    assert not t.is_alive() and not err, err
    assert np.isfinite(result["final_loss"]) and result["last_iteration"] == 40
    # the frame on the wire is the port's render_frame through the viewer's
    # camera (with the trained MLPs), as 8-bit pixels
    assert len(served) == 1
    camera, kw, img = served[0]
    np.testing.assert_array_equal(
        frame, (np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8))
    view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1:3] *= -1
    np.testing.assert_array_equal(camera.w2c.numpy(), view.T)
    assert set(kw["mlp_params"]) == {"pose_refiner", "lbs_offset"}
    assert kw["scaling_modifier"] == 1.0 and bool(torch.isfinite(img).all())
