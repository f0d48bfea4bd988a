"""Interactive progressive preview: a live window and an orbit rig (twin of
ti_raytrace_tpu/examples/preview.py).

A pygame window shows the film's current sRGB state, with frame/total and
fps in its title bar; the orbit rig is driven by mouse or keyboard:

    left-drag   orbit yaw / pitch
    wheel       dolly in / out
    arrows      orbit yaw / pitch
    + / -       dolly in / out
    q / ESC     quit

Moving the camera restarts progressive accumulation.  `OrbitRig` is a
pure state machine, testable without a display; `PygamePreview` is the
window and event layer (it imports pygame when it is made, and runs
headless under SDL_VIDEODRIVER=dummy).
"""

import numpy as np

from ti_raytrace_tpu_torch.camera import orbit_camera

YAW_STEP = 0.1       # radians per key press
PITCH_STEP = 0.1
ZOOM_STEP = 0.9      # multiplicative dolly factor
PITCH_LIMIT = 1.5    # orbit_camera clips at +-1.57
DRAG_SCALE = 0.01    # radians per pixel of mouse drag


class OrbitRig:
    """Orbit-camera state: target, yaw, pitch, scale -> CameraState on
    `device`.  `apply`, `drag` and `wheel` change the rig and return True
    when the camera moved (the caller then restarts accumulation)."""

    ACTIONS = ("yaw+", "yaw-", "pitch+", "pitch-", "zoom_in", "zoom_out")

    def __init__(self, target, yaw: float, pitch: float, scale: float, device="cuda"):
        self.target = np.asarray(target, np.float64)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.scale = float(scale)
        self.device = device

    def apply(self, action: str) -> bool:
        if action == "yaw+":
            self.yaw += YAW_STEP
        elif action == "yaw-":
            self.yaw -= YAW_STEP
        elif action == "pitch+":
            self.pitch = min(self.pitch + PITCH_STEP, PITCH_LIMIT)
        elif action == "pitch-":
            self.pitch = max(self.pitch - PITCH_STEP, -PITCH_LIMIT)
        elif action == "zoom_in":
            self.scale *= ZOOM_STEP
        elif action == "zoom_out":
            self.scale /= ZOOM_STEP
        else:
            return False
        return True

    def drag(self, dx: float, dy: float) -> bool:
        """Mouse-drag orbit: dx pixels -> yaw, dy pixels -> pitch."""
        if dx == 0 and dy == 0:
            return False
        self.yaw += dx * DRAG_SCALE
        self.pitch = min(max(self.pitch + dy * DRAG_SCALE, -PITCH_LIMIT), PITCH_LIMIT)
        return True

    def wheel(self, steps: float) -> bool:
        """Mouse-wheel dolly: positive steps (wheel up) zoom in."""
        if steps == 0:
            return False
        self.scale *= ZOOM_STEP ** steps
        return True

    def camera(self):
        return orbit_camera(self.target, self.yaw, self.pitch, self.scale, device=self.device)


class PygamePreview:
    """Live preview window.  `poll()` pumps events and returns 'quit',
    'camera' (the rig moved) or None; `show(img_u8)` refreshes it."""

    def __init__(self, rig: OrbitRig, width: int, height: int, title: str = "ti_raytrace"):
        import pygame

        self._pg = pygame
        self.rig = rig
        self.title = title
        self._dragging = False
        pygame.display.init()
        self.screen = pygame.display.set_mode((width, height))
        pygame.display.set_caption(title)
        self.keymap = {
            pygame.K_LEFT: "yaw-",
            pygame.K_RIGHT: "yaw+",
            pygame.K_UP: "pitch+",
            pygame.K_DOWN: "pitch-",
            pygame.K_PLUS: "zoom_in",
            pygame.K_EQUALS: "zoom_in",
            pygame.K_MINUS: "zoom_out",
        }

    def poll(self):
        pg = self._pg
        changed = False
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                return "quit"
            if ev.type == pg.KEYDOWN:
                if ev.key in (pg.K_q, pg.K_ESCAPE):
                    return "quit"
                action = self.keymap.get(ev.key)
                if action is not None:
                    changed |= self.rig.apply(action)
            elif ev.type == pg.MOUSEBUTTONDOWN and ev.button == 1:
                self._dragging = True
            elif ev.type == pg.MOUSEBUTTONUP and ev.button == 1:
                self._dragging = False
            elif ev.type == pg.MOUSEMOTION and self._dragging:
                dx, dy = ev.rel
                changed |= self.rig.drag(dx, dy)
            elif ev.type == pg.MOUSEWHEEL:
                changed |= self.rig.wheel(ev.y)
        return "camera" if changed else None

    def set_hud(self, frame: int, total: int, fps: float) -> None:
        """Progress and rate in the title bar."""
        self._pg.display.set_caption(f"{self.title} — {frame}/{total} spp  {fps:.1f} fps")

    def show(self, img_u8: np.ndarray) -> None:
        """img_u8: (W, H, 3) uint8 in the film's layout (y up); pygame's
        surfaces are (x, y) with y down, so y is flipped."""
        pg = self._pg
        surf = pg.surfarray.make_surface(np.ascontiguousarray(img_u8[:, ::-1, :]))
        self.screen.blit(surf, (0, 0))
        pg.display.flip()

    def close(self) -> None:
        self._pg.display.quit()
