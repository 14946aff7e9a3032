"""ANSI terminal rendering: images as 24-bit half-block cells.

Replaces the reference's four OpenCV windows for terminal sessions: each
character cell shows two vertical pixels via '▀' with truecolor fg/bg.
Pure string generation (testable); the interactive loop lives in cli/tui.py.

A copy of :mod:`spectralae.viz.ansi` (framework-free).
"""

from __future__ import annotations

import numpy as np

RESET = "\x1b[0m"

_ANSI_RE = None


def _visible_len(line: str) -> int:
    """Character-cell width of a rendered line (ANSI escapes stripped)."""
    global _ANSI_RE
    if _ANSI_RE is None:
        import re
        _ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")
    return len(_ANSI_RE.sub("", line))


def _downsample(img: np.ndarray, max_w: int, max_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    step = max(1, (w + max_w - 1) // max_w, (h + max_h - 1) // max_h)
    return img[::step, ::step]


def render_image(img: np.ndarray, *, max_width: int = 60,
                 max_height: int = 56) -> str:
    """uint8 [H,W] or [H,W,3] → ANSI half-block string (two rows per line)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    img = _downsample(img, max_width, max_height)
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, np.zeros((1, w, 3), np.uint8)], axis=0)
        h += 1
    lines = []
    for r in range(0, h, 2):
        parts = []
        for cc in range(w):
            tr, tg, tb = (int(v) for v in img[r, cc])
            br, bg, bb = (int(v) for v in img[r + 1, cc])
            parts.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(parts) + RESET)
    return "\n".join(lines)


def render_dashboard(views: dict[str, np.ndarray], status: str, *,
                     width: int = 60) -> str:
    """The four reference windows side by side + a status line."""
    blocks = []
    row = []
    for name in ("input", "output"):
        if name in views:
            row.append((name, render_image(views[name], max_width=width // 2 - 1)))
    blocks.append(row)
    row = []
    for name in ("feature_map", "kernel"):
        if name in views:
            row.append((name, render_image(views[name], max_width=width // 2 - 1)))
    blocks.append(row)
    out = [status]
    for row in blocks:
        if not row:
            continue
        rendered = [(n, r.split("\n")) for n, r in row]
        height = max(len(r) for _, r in rendered)
        title = "   ".join(f"{n:<30}" for n, _ in rendered)
        out.append(title)
        widths = [max((_visible_len(l) for l in r), default=1)
                  for _, r in rendered]
        for i in range(height):
            out.append("   ".join(
                (r[i] if i < len(r) else " " * w)
                for (_, r), w in zip(rendered, widths)))
    return "\n".join(out)
