"""Interactive terminal viewer — the winit/egui front end, TUI edition.

The reference presents through a winit window with an egui debug panel
(``src/main.rs``, ``src/context.rs:1692-1827``).  A headless GPU
server has no display, but any ssh terminal does: frames render to 24-bit ANSI
half-block cells, the fly camera runs on the same key bindings
(WASD/QE move, arrow keys look — terminals deliver no mouse deltas or
key-up events, so look is arrow-stepped), and every live slider of the
reference's egui panel has a live key binding here.

Controls (every egui slider, src/context.rs:1692-1827):
  w/a/s/d/q/e  move (each keypress steps 1/15 s of movement)
  arrows       look around
  [ / ]        sun yaw          { / }   sun pitch
  - / =        sun strength     _ / +   sun size
  , / .        specularity      v / V   emit strength
  f / F        temporal blending factor
  x / X        temporal maximum blending
  c / C        temporal distance cutoff (log scale)
  ; / '        denoise radius (0..8; recompiles, like a pipeline rebuild)
  g / G        denoise sigma distance
  h / H        denoise sigma range
  b / B        albedo factor
  m            cycle scene      r       reset accumulation
  p            save snapshot    ESC/ctrl-c  quit
(sun color / sky color are CLI flags --sun-color/--sky-color; a
terminal has no color picker widget.)

Run: ``python -m voxtracer.app.viewer --scene menger --size 256x144``
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from ..engine.pipeline import Renderer
from ..utils import FpsCounter
from ..utils.compile_cache import enable_compile_cache
from . import camera_paths
from .cli import available_scenes, load_scene
from .input import FlyController


# 256 zero-padded 3-digit decimal byte triples ("000".."255") — ANSI
# SGR accepts leading zeros, which makes every cell a FIXED 41 bytes
# and lets the whole frame assemble as one vectorized u8 array write.
_DEC3 = np.frombuffer(
    b"".join(b"%03d" % i for i in range(256)), np.uint8
).reshape(256, 3)
_CELL_FG = np.frombuffer(b"\x1b[38;2;", np.uint8)  # + R;G;B + m
_CELL_BG = np.frombuffer(b"\x1b[48;2;", np.uint8)
_SEMI = ord(";")
_M = ord("m")
_UPPER_HALF = np.frombuffer("▀".encode(), np.uint8)  # 3 bytes
_ROW_TAIL = np.frombuffer(b"\x1b[0m\n", np.uint8)


def _fit_size(rows: int, cols: int) -> tuple[int, int]:
    """Render size (h, w) filling a rows x cols terminal: two pixel
    rows per text row (half blocks), one text row reserved for the
    status line and one spare column for the cursor.  Heights stay
    even (half-block cells pair pixel rows)."""
    h = max(16, 2 * (rows - 2))
    w = max(16, cols - 1)
    return h - (h % 2), w


def _halfblock_frame(img: np.ndarray) -> str:
    """(H, W, 3) u8 -> ANSI string, two pixel rows per text row.

    Fully vectorized: the per-cell f-string version built ~18k Python
    strings per 256x144 frame, and the terminal front end throttled
    long before the renderer did."""
    h = img.shape[0] - (img.shape[0] % 2)
    top = img[0:h:2]
    bot = img[1:h:2]
    nrows, w = top.shape[0], top.shape[1]
    cell = np.empty((nrows, w, 41), np.uint8)
    cell[:, :, 0:7] = _CELL_FG
    cell[:, :, 7:10] = _DEC3[top[..., 0]]
    cell[:, :, 10] = _SEMI
    cell[:, :, 11:14] = _DEC3[top[..., 1]]
    cell[:, :, 14] = _SEMI
    cell[:, :, 15:18] = _DEC3[top[..., 2]]
    cell[:, :, 18] = _M
    cell[:, :, 19:26] = _CELL_BG
    cell[:, :, 26:29] = _DEC3[bot[..., 0]]
    cell[:, :, 29] = _SEMI
    cell[:, :, 30:33] = _DEC3[bot[..., 1]]
    cell[:, :, 33] = _SEMI
    cell[:, :, 34:37] = _DEC3[bot[..., 2]]
    cell[:, :, 37] = _M
    cell[:, :, 38:41] = _UPPER_HALF
    rows = np.empty((nrows, w * 41 + len(_ROW_TAIL)), np.uint8)
    rows[:, : w * 41] = cell.reshape(nrows, -1)
    rows[:, w * 41:] = _ROW_TAIL
    # drop the final newline; callers join frames themselves
    return rows.tobytes()[: -1].decode()


class ViewerState:
    """Key-driven live parameter panel — the egui window's state machine,
    separated from curses so tests can drive it directly.

    Every slider in the reference's debug panel
    (``src/context.rs:1692-1827``) maps to a key pair; ranges and
    defaults match the egui widgets.
    """

    def __init__(self, renderer: Renderer, controller: FlyController,
                 scenes=None, scene_idx: int = 0):
        self.renderer = renderer
        self.ctl = controller
        self.scenes = scenes or ["default"]
        self.scene_idx = scene_idx
        self.move_step = 1.0 / 15.0
        self.look_pixels = 40.0

    # -- helpers ------------------------------------------------------
    def _render(self, **kv):
        r = self.renderer
        r.render_params = dataclasses.replace(r.render_params, **kv)

    def _temporal(self, **kv):
        r = self.renderer
        r.temporal_params = dataclasses.replace(r.temporal_params, **kv)

    def _denoise(self, **kv):
        r = self.renderer
        r.denoise_params = dataclasses.replace(r.denoise_params, **kv)

    def cycle_scene(self):
        self.scene_idx = (self.scene_idx + 1) % len(self.scenes)
        try:
            self.renderer.set_scene(load_scene(self.scenes[self.scene_idx]))
        except Exception:
            # keep rendering the old scene, like the reference's
            # vox-load failure path (src/context.rs:1817-1818)
            pass

    def handle_key(self, c: str) -> bool:
        """Apply one key. Returns False for quit, True otherwise."""
        rp = self.renderer.render_params
        tp = self.renderer.temporal_params
        dp = self.renderer.denoise_params
        if c == "\x1b":
            return False
        elif c in "wasdqe":
            self.ctl.pressed = {c}
            self.ctl.update(self.move_step)
            self.ctl.pressed = set()
        elif c == "[":
            self._render(sun_yaw=rp.sun_yaw - 0.1)
        elif c == "]":
            self._render(sun_yaw=rp.sun_yaw + 0.1)
        elif c == "{":
            self._render(sun_pitch=max(0.0, rp.sun_pitch - 0.1))
        elif c == "}":
            self._render(sun_pitch=min(np.pi / 2, rp.sun_pitch + 0.1))
        elif c == "-":
            self._render(sun_strength=max(0.0, rp.sun_strength - 0.5))
        elif c == "=":
            self._render(sun_strength=min(10.0, rp.sun_strength + 0.5))
        elif c == "_":
            self._render(sun_size=max(0.0, rp.sun_size - 0.01))
        elif c == "+":
            self._render(sun_size=min(1.0, rp.sun_size + 0.01))
        elif c == ",":
            self._render(specularity=max(0.0, rp.specularity - 0.1))
        elif c == ".":
            self._render(specularity=min(1.0, rp.specularity + 0.1))
        elif c == "v":
            self._render(emit_strength=max(0.0, rp.emit_strength - 0.5))
        elif c == "V":
            self._render(emit_strength=min(32.0, rp.emit_strength + 0.5))
        elif c == "f":
            self._temporal(
                sample_blending=max(0.0, tp.sample_blending - 0.05)
            )
        elif c == "F":
            self._temporal(
                sample_blending=min(1.0, tp.sample_blending + 0.05)
            )
        elif c == "x":
            self._temporal(
                maximum_blending=max(0.0, tp.maximum_blending - 0.01)
            )
        elif c == "X":
            self._temporal(
                maximum_blending=min(1.0, tp.maximum_blending + 0.01)
            )
        elif c == "c":
            self._temporal(
                blending_distance_cutoff=max(
                    1e-6, tp.blending_distance_cutoff / 1.5
                )
            )
        elif c == "C":
            self._temporal(
                blending_distance_cutoff=min(
                    1.0, tp.blending_distance_cutoff * 1.5
                )
            )
        elif c == ";":
            self.renderer.denoise_radius = max(
                0, self.renderer.denoise_radius - 1
            )
        elif c == "'":
            self.renderer.denoise_radius = min(
                8, self.renderer.denoise_radius + 1
            )
        elif c == "g":
            self._denoise(sigma_distance=max(0.25, dp.sigma_distance - 0.25))
        elif c == "G":
            self._denoise(sigma_distance=min(8.0, dp.sigma_distance + 0.25))
        elif c == "h":
            self._denoise(sigma_range=max(0.25, dp.sigma_range - 0.25))
        elif c == "H":
            self._denoise(sigma_range=min(8.0, dp.sigma_range + 0.25))
        elif c == "b":
            self._denoise(albedo_factor=max(0.0, dp.albedo_factor - 0.1))
        elif c == "B":
            self._denoise(albedo_factor=min(1.0, dp.albedo_factor + 0.1))
        elif c == "m":
            self.cycle_scene()
        elif c == "r":
            self.renderer.reset_accumulation()
        elif c == "p":
            from ..engine import snapshot

            snapshot.save("viewer_snapshot.npz", self.renderer,
                          self.ctl.camera)
        return True

    def status_line(self, fps: float) -> str:
        r = self.renderer
        mrays = r.height * r.width * fps / 1e6  # primary rays (1 spp)
        return (
            f" {self.scenes[self.scene_idx]} {r.width}x{r.height} "
            f"fps:{fps:5.1f} Mray/s:{mrays:6.1f} "
            f"sun:{r.render_params.sun_strength:.1f}"
            f"@{r.render_params.sun_yaw:.2f}/{r.render_params.sun_pitch:.2f} "
            f"spec:{r.render_params.specularity:.1f} "
            f"tf:{r.temporal_params.sample_blending:.2f} "
            f"r:{r.denoise_radius} "
            f"[wasdqe move, arrows look, m scene, ESC quit]"
        )


def run_viewer(args) -> int:
    import curses

    scenes = ["default"] + available_scenes()
    scene_idx = (
        scenes.index(args.scene) if args.scene in scenes else 0
    )
    width, height = (int(v) for v in args.size.lower().split("x"))
    renderer = Renderer(
        scene=load_scene(scenes[scene_idx]),
        height=height,
        width=width,
        denoise_radius=args.denoise_radius,
        trace_impl=args.trace_impl,
        lean=True,
    )
    ctl = FlyController()
    # start from a framing view of the scene
    cam0 = camera_paths.static(renderer.scene)(0.0)
    ctl.camera = cam0
    d = cam0.direction / np.linalg.norm(cam0.direction)
    ctl.pitch = float(np.arcsin(d[1]))
    ctl.yaw = float(np.arctan2(d[0], d[2]))
    vs = ViewerState(renderer, ctl, scenes, scene_idx)
    # kernel hot-reload runs during the live session, like the
    # reference's shader watcher (src/context.rs:1637-1657); a failed
    # reload keeps the old kernels (engine/reload.py)
    from ..engine.reload import KernelWatcher

    watcher = KernelWatcher()

    def loop(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)
        fps = FpsCounter()
        look = vs.look_pixels
        pending = None
        while True:
            try:
                watcher.poll()
            except Exception:
                pass  # non-fatal, like cli.py's poll
            # drain input
            while True:
                ch = stdscr.getch()
                if ch == -1:
                    break
                if ch == curses.KEY_RESIZE:
                    # SIGWINCH: refit the render size to the terminal
                    # (the reference recreates size-dependent resources
                    # on window resize, src/context.rs:1430-1461).  The
                    # in-flight lookahead frame is the old size — drop
                    # it; accumulation restarts inside resize().
                    renderer.resize(*_fit_size(*stdscr.getmaxyx()))
                    pending = None
                    stdscr.erase()
                    continue
                key = {
                    curses.KEY_UP: ("look", 0, -look),
                    curses.KEY_DOWN: ("look", 0, look),
                    curses.KEY_LEFT: ("look", -look, 0),
                    curses.KEY_RIGHT: ("look", look, 0),
                }.get(ch)
                if key is not None:
                    ctl.cursor_grabbed = True
                    ctl.mouse_delta(key[1], key[2])
                    continue
                c = chr(ch) if 0 < ch < 256 else ""
                if not vs.handle_key(c):
                    return

            cam = ctl.update(0.0)
            out = renderer.render(cam)
            # one frame of lookahead: blit LAST frame's image while the
            # device works on this one (a blocking per-frame fetch
            # serializes the dispatch pipeline — see app/web._loop)
            try:
                out["image"].copy_to_host_async()
            except (AttributeError, NotImplementedError, TypeError):
                pass  # backend without async copy
            if pending is None:
                pending = out["image"]
                continue
            img = np.asarray(pending)
            pending = out["image"]
            fps.tick()

            rows, cols = stdscr.getmaxyx()
            vis_w = min(img.shape[1], cols - 1)
            vis_h = min(img.shape[0], 2 * (rows - 2))
            frame = _halfblock_frame(img[:vis_h, :vis_w])
            stdscr.erase()
            try:
                for i, line in enumerate(frame.split("\n")):
                    stdscr.addstr(i, 0, line)
                status = vs.status_line(fps.fps)
                stdscr.addstr(
                    min(rows - 1, vis_h // 2 + 1), 0, status[: cols - 1]
                )
            except curses.error:
                pass
            stdscr.refresh()

    import curses

    curses.wrapper(loop)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="menger")
    p.add_argument("--size", default="192x108")
    p.add_argument("--denoise-radius", type=int, default=0)
    p.add_argument("--trace-impl", default=None, choices=["triton", "xla"])
    args = p.parse_args(argv)
    enable_compile_cache()
    if not sys.stdout.isatty():
        print("viewer needs an interactive terminal", file=sys.stderr)
        return 1
    return run_viewer(args)


if __name__ == "__main__":
    sys.exit(main())
