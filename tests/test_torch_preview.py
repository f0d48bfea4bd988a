"""The port's preview (ti_raytrace_tpu_torch/examples/preview.py), the orbit
camera helpers and the CLI's --preview loop, on the CPU.

The rig and the camera helpers are held to the JAX package's (float64
numpy on both sides, stored as float32: rtol 1e-6).  The window and the
CLI loop run under SDL's dummy video driver when pygame is installed
(skipped where it is not); without pygame, --preview raises pygame's own
ImportError and renders nothing.
"""

import json
import sys

import numpy as np
import pytest
import torch

from ti_raytrace_tpu.camera import frame_scene_camera as jframe
from ti_raytrace_tpu.camera import orbit_pitch as jpitch
from ti_raytrace_tpu.camera import orbit_yaw as jyaw
from ti_raytrace_tpu.examples.preview import OrbitRig as JRig
from ti_raytrace_tpu_torch import camera as tcam
from ti_raytrace_tpu_torch.examples.preview import OrbitRig

torch.set_num_threads(2)

TARGET = np.array([0.3, -1.2, 2.5])


def _assert_cam_close(tc, jc):
    for f in ("view", "view_inv", "eye"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("yaw,pitch", [(0.0, 0.0), (3.2, 0.4), (-1.0, 0.6)])
def test_orbit_steps_match_reference(yaw, pitch):
    """One step of each orbit animation, below and at its limit."""
    ny, cy = tcam.orbit_yaw(TARGET, yaw, pitch, 7.0, device="cpu")
    jy, jcy = jyaw(TARGET, yaw, pitch, 7.0)
    assert ny == jy
    _assert_cam_close(cy, jcy)
    npi, cp = tcam.orbit_pitch(TARGET, yaw, pitch, 7.0, step=0.05, device="cpu")
    jp, jcp = jpitch(TARGET, yaw, pitch, 7.0, step=0.05)
    assert npi == jp
    _assert_cam_close(cp, jcp)


def test_frame_scene_camera_matches_reference():
    lo, hi = np.array([-1.0, 0.0, -2.0]), np.array([3.0, 2.5, 1.0])
    _assert_cam_close(tcam.frame_scene_camera(lo, hi, 0.3, -0.2, device="cpu"),
                      jframe(lo, hi, 0.3, -0.2))


def test_orbit_rig_matches_reference():
    """The same sequence of key actions, drags and wheel steps moves both
    rigs alike (pitch clamped at its limit), and their cameras agree."""
    ours, ref = OrbitRig(TARGET, 0.1, 0.2, 5.0, device="cpu"), JRig(TARGET, 0.1, 0.2, 5.0)
    moves = ([("apply", a) for a in OrbitRig.ACTIONS] + [("apply", "nonsense")]
             + [("apply", "pitch+")] * 20 + [("drag", (12, -7)), ("drag", (0, 0)),
                                            ("wheel", 2), ("wheel", 0), ("wheel", -1)])
    for kind, arg in moves:
        args = arg if isinstance(arg, tuple) else (arg,)
        assert getattr(ours, kind)(*args) == getattr(ref, kind)(*args), (kind, arg)
        assert (ours.yaw, ours.pitch, ours.scale) == (ref.yaw, ref.pitch, ref.scale)
    _assert_cam_close(ours.camera(), ref.camera())


def test_pygame_window_headless(monkeypatch):
    pg = pytest.importorskip("pygame")
    from ti_raytrace_tpu_torch.examples.preview import PygamePreview

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    rig = OrbitRig(TARGET, 0.0, 0.0, 5.0, device="cpu")
    win = PygamePreview(rig, 16, 8, "t")
    try:
        img = np.zeros((16, 8, 3), np.uint8)
        img[3, 0] = (255, 0, 0)  # film (x=3, y=0): the bottom row
        win.show(img)
        assert tuple(win.screen.get_at((3, 7)))[:3] == (255, 0, 0)
        win.set_hud(3, 10, 12.5)
        assert pg.display.get_caption()[0] == "t — 3/10 spp  12.5 fps"
        assert win.poll() is None
        pg.event.post(pg.event.Event(pg.KEYDOWN, key=pg.K_LEFT))
        assert win.poll() == "camera" and rig.yaw == pytest.approx(-0.1)
        pg.event.post(pg.event.Event(pg.KEYDOWN, key=pg.K_q))
        assert win.poll() == "quit"
    finally:
        win.close()


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_preview_loop(monkeypatch, capsys, tmp_path):
    """--preview renders one frame per call into the window; an orbit move
    restarts the accumulation from frame 0; quit ends the run."""
    pytest.importorskip("pygame")
    from ti_raytrace_tpu_torch.examples import preview, run

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    polls, shown = [], []
    real_show = preview.PygamePreview.show

    def poll(self):
        polls.append(self.rig.yaw)
        return "camera" if len(polls) == 2 and self.rig.apply("yaw+") else None

    def show(self, img):
        shown.append(img.shape)
        real_show(self, img)

    monkeypatch.setattr(preview.PygamePreview, "poll", poll)
    monkeypatch.setattr(preview.PygamePreview, "show", show)
    out = tmp_path / "p.png"
    run.main(["cornell_box", "--size", "8", "--frames", "3", "--device", "cpu", "--preview",
              "--out", str(out)])
    line = _json_line(capsys)
    # frames 1, 2 (moved: restart), then 1, 2, 3 of the new view
    assert len(polls) == len(shown) == 5 and shown[0] == (8, 8, 3)
    assert polls[2] == pytest.approx(polls[0] + 0.1)
    assert line["frames"] == 3 and line["batch"] == 1 and line["group"] is None
    assert out.exists()

    monkeypatch.setattr(preview.PygamePreview, "poll", lambda self: "quit")
    run.main(["cornell_box", "--size", "8", "--frames", "5", "--device", "cpu", "--preview",
              "--out", str(out)])
    assert _json_line(capsys)["frames"] == 1


def test_cli_preview_without_pygame_raises(monkeypatch):
    """Without pygame (the card's machine has none) --preview fails with
    pygame's ImportError before any frame is rendered."""
    from ti_raytrace_tpu_torch.examples import run

    monkeypatch.setitem(sys.modules, "pygame", None)
    rendered = []
    monkeypatch.setattr(run, "render_batch", lambda *a, **k: rendered.append(1))
    with pytest.raises(ImportError, match="pygame"):
        run.main(["cornell_box", "--size", "8", "--frames", "1", "--device", "cpu",
                  "--preview", "--out", "/dev/null"])
    assert not rendered
