"""Terminal UI: the reference's interactive app, in ANSI.

Live loop over a frame source with the four reference views rendered as
truecolor half-blocks and single-keypress command dispatch (raw termios) —
the full 20-command interactive experience without OpenCV windows.
Invoked via ``spectralae-torch run --tui``.  A copy of
:mod:`spectralae.cli.tui` on the port's engine.
"""

from __future__ import annotations

import select
import sys
import time

from ..data import pipeline
from ..model.engine import Engine, dispatch_key
from ..viz.ansi import render_dashboard

CLEAR_HOME = "\x1b[2J\x1b[H"
HOME = "\x1b[H"


def _read_key(timeout: float = 0.0) -> str | None:
    r, _, _ = select.select([sys.stdin], [], [], timeout)
    if r:
        return sys.stdin.read(1)
    return None


def run_tui(eng: Engine, source, *, nx: int, ny: int,
            frames: int | None = None, out=sys.stdout) -> None:
    """Main loop: step, render, dispatch.  Esc or 'Q' quits."""
    import termios
    import tty
    try:
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        raw_mode = True
    except Exception:  # not a real tty (tests, pipes) — keys still polled
        raw_mode = False
    try:
        out.write(CLEAR_HOME)
        i = 0
        while frames is None or i < frames:
            frame = next(source)
            x = pipeline.frame_to_tensor(pipeline.resize_nn(frame, nx, ny))
            t0 = time.perf_counter()
            eng.step(x, need_tape=True)
            dt = (time.perf_counter() - t0) * 1e3
            f = eng.flags
            status = (f"frame {i}  {dt:6.1f} ms  layer {f.n_l}  feat {f.feat}"
                      f"  lr {f.lr:.4g}  α {f.alpha:.1f}  "
                      f"[{'fft' if f.fft else 'coord'}]"
                      f"{' TRAIN' if f.sel else ''}"
                      f"{' sym' if f.sym else ''}"
                      f"{' maxdiff' if f.maxdiff else ''}"
                      f"  mse {eng.last_mse if eng.last_mse is not None else float('nan'):.4g}")
            out.write(HOME + render_dashboard(eng.current_views(), status)
                      + "\n(keys: 1..9,0,f,g,q,w,m,z,x,e,c,p,s,l,n,d,i; "
                        "Esc/Q quit)\x1b[J")
            out.flush()
            key = _read_key(0.0)
            if key in ("\x1b", "Q"):
                break
            if key:
                try:
                    dispatch_key(eng, key)
                except (OSError, ValueError):
                    pass
            i += 1
    finally:
        if raw_mode:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        out.write("\n")
