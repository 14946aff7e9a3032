"""The plain reference of one train step of the mirrored autoencoder.

Straight PyTorch, written from the net's description and not from the code
under test (it imports nothing of the program): the forward in either
domain, the loss ½·mean((out − x)²), the gradients by autograd, and the
reference's inertia update (backproplib.cu:392-396)::

    dw ← (1−α)·lr·g / max(|g|, 10) + α·dw_prev ;  w ← w − dw

The net (``cfg``: ``d``, ``depth``, ``nk``, ``nl``, ``scale``, ``pairs``)
is ``pairs`` encoder stages (pool, then conv ``d`` → ``depth``) and their
mirrors (conv, then unpool).  Each conv divides its input by its output
channels and adds its bias, with the taps centred on the output pixel.

- ``fft``: one rfft2 of the frames; at each stage the spectrum is cropped
  (encoder) or zero-padded (decoder) as the reference's ``resize`` kernel
  does (fft_backproplib.cu:87-157, its Nyquist rows and columns included),
  multiplied bin by bin with the rfft2 of the circularly padded taps,
  summed over input channels, the bias put on the DC bin times the grid's
  pixels; one normalised irfft2 at the end.  The products over channels
  are real matrix products, so that TF32, where it is switched on, reaches
  them.
- ``coord``: zero-padded correlation with the flipped taps; max-pooling
  over ``scale`` × ``scale`` blocks clamped at zero, nearest upsampling.

Gradients are taken over blocks of ``rows`` frames and summed, so that the
step at a benchmark's batch fits beside what the card already holds.
:func:`train` runs its own steps from the seed's weights; :func:`follow`
runs each step from the weights a program gave that step.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

GRAD_FLOOR = 10.0


def _axis_map(n: int, ns: int, half: bool):
    """Index and mask of a spectrum axis resized from ``n`` to ``ns``
    points (``half``: the rfft axis, ``n`` and ``ns`` its bins)."""
    i = torch.arange(ns)
    keep = torch.ones(ns, dtype=torch.bool)
    if half:
        if ns <= n:
            idx = torch.where(i < ns - 1, i, n - 1)
        else:
            idx = torch.where(i < n - 1, i, torch.where(i == ns - 1, n - 1, 0))
            keep = (i < n - 1) | (i == ns - 1)
        return idx, keep
    if ns <= n:
        idx = torch.where(i < ns // 2, i,
                          torch.where(i == ns // 2, n // 2, i + n - ns))
    else:
        low, high, nyq = i < n // 2, i > ns - n // 2, i == ns // 2
        idx = torch.where(low, i, torch.where(high, i - ns + n,
                                              torch.where(nyq, n // 2, 0)))
        keep = low | high | nyq
    return idx, keep


def resize(X: torch.Tensor, nx: int, ny: int, nxs: int, nys: int):
    """Crop or zero-pad an ``[..., nx, ny//2+1]`` half-spectrum to
    ``[..., nxs, nys//2+1]``."""
    rows, rkeep = _axis_map(nx, nxs, False)
    cols, ckeep = _axis_map(ny // 2 + 1, nys // 2 + 1, True)
    mask = (rkeep[:, None] & ckeep[None, :]).to(X.device)
    out = X.index_select(-2, rows.to(X.device))
    out = out.index_select(-1, cols.to(X.device))
    return out * mask


def kernel_spectrum(c: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """rfft2 of the taps placed on an ``nx`` × ``ny`` grid with their centre
    at the origin (wrapped round the four corners)."""
    nk, nl = c.shape[-2:]
    full = c.new_zeros(c.shape[:-2] + (nx, ny))
    full[..., :nk, :nl] = c
    full = torch.roll(full, (-(nk // 2), -(nl // 2)), dims=(-2, -1))
    return torch.fft.rfft2(full)


def contract(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``out[b, m, ω] = Σ_d X[b, d, ω]·C[m, d, ω]`` as real matrix products
    at each bin."""
    b, d = X.shape[:2]
    m = C.shape[0]
    grid = X.shape[2:]
    xr = X.real.reshape(b, d, -1).permute(2, 0, 1)     # [P, B, D]
    xi = X.imag.reshape(b, d, -1).permute(2, 0, 1)
    cr = C.real.reshape(m, d, -1).permute(2, 1, 0)     # [P, D, M]
    ci = C.imag.reshape(m, d, -1).permute(2, 1, 0)
    re = torch.bmm(xr, cr) - torch.bmm(xi, ci)
    im = torch.bmm(xr, ci) + torch.bmm(xi, cr)
    out = torch.complex(re, im).permute(1, 2, 0)        # [B, M, P]
    return out.reshape(b, m, *grid)


def forward_fft(params, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    s = cfg["scale"]
    n = len(params)
    cx, cy = x.shape[-2:]
    X = torch.fft.rfft2(x)
    for i, (c, bias) in enumerate(params):
        if i < n // 2:
            X = resize(X, cx, cy, cx // s, cy // s)
            cx, cy = cx // s, cy // s
        m = c.shape[0]
        X = contract(X / m, kernel_spectrum(c, cx, cy))
        dc = torch.zeros(X.shape[-2:], dtype=X.real.dtype, device=X.device)
        dc[0, 0] = cx * cy
        X = X + bias[:, None, None] * dc
        if i >= n // 2:
            X = resize(X, cx, cy, cx * s, cy * s)
            cx, cy = cx * s, cy * s
    return torch.fft.irfft2(X, s=(cx, cy))


def forward_coord(params, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    s = cfg["scale"]
    n = len(params)
    h = x
    for i, (c, bias) in enumerate(params):
        if i < n // 2:
            b_, ch, hh, ww = h.shape
            h = h.reshape(b_, ch, hh // s, s, ww // s, s).amax(dim=(3, 5))
            h = torch.clamp(h, min=0.0)
        m, _, nk, nl = c.shape
        h = F.conv2d(h / m, torch.flip(c, (-2, -1)),
                     padding=(nk // 2, nl // 2)) + bias[None, :, None, None]
        if i >= n // 2:
            h = torch.repeat_interleave(h, s, dim=-2)
            h = torch.repeat_interleave(h, s, dim=-1)
    return h


FORWARDS = {"fft": forward_fft, "coord": forward_coord}


def loss_and_grads(leaves, x: torch.Tensor, cfg: dict, domain: str,
                   rows: int):
    """``(loss, grads)`` of ½·mean((forward(x) − x)²) at ``leaves`` (``c``,
    ``b`` of each stage), over blocks of ``rows`` frames."""
    ws = [t.detach().clone().requires_grad_() for t in leaves]
    params = list(zip(ws[0::2], ws[1::2]))
    total = x.new_zeros(())
    for xs in x.split(rows):
        out = FORWARDS[domain](params, xs, cfg)
        part = 0.5 * torch.sum((out - xs) ** 2) / x.numel()
        part.backward()
        total = total + part.detach()
    return total, [w.grad for w in ws]


def update(w, g, mom, lr: float, alpha: float):
    dw = (1.0 - alpha) * lr * g / torch.clamp(g.abs(), min=GRAD_FLOOR) \
        + alpha * mom
    return w - dw, dw


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 for cuBLAS and cuDNN on or off inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def train(leaves, batches, cfg: dict, domain: str, *,
          dtype=torch.float64, tf32: bool = False, rows: int = 4) -> dict:
    """Run the reference over ``batches`` (one step each) from ``leaves``
    with zero inertia, in ``dtype``, as a program the check judges.
    Returns each step's loss, the first step's gradient and ``params``:
    the weights each step receives, and those after the last."""
    w = [t.detach().to(dtype) for t in leaves]
    states = [w]
    mom = [torch.zeros_like(t) for t in w]
    losses, grad1 = [], None
    with precision(tf32):
        for x in batches:
            loss, grads = loss_and_grads(w, x.to(dtype), cfg, domain, rows)
            losses.append(float(loss))
            if grad1 is None:
                grad1 = [g.detach() for g in grads]
            new = [update(wi, g, m, cfg["lr"], cfg["alpha"])
                   for wi, g, m in zip(w, grads, mom)]
            w = [t for t, _ in new]
            mom = [d for _, d in new]
            states.append(w)
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"reference loss not finite: {losses}")
    return {"losses": losses, "grad1": grad1, "params": states}


def follow(states, batches, cfg: dict, domain: str, *,
           dtype=torch.float64, rows: int = 4) -> dict:
    """Each step of the reference from the weights a program gave that
    step: step ``k`` starts from ``states[k]`` with the inertia
    ``states[k-1] - states[k]`` (none at the first step) and runs on
    ``batches[k]``.  Returns each step's loss, gradient and update ``dw``
    (the weights the next step should receive are ``states[k] - dw``)."""
    out = {"losses": [], "grads": [], "updates": []}
    prev = None
    for w, x in zip(states, batches):
        w = [t.detach().to(dtype) for t in w]
        mom = ([a - b for a, b in zip(prev, w)] if prev is not None
               else [torch.zeros_like(t) for t in w])
        loss, grads = loss_and_grads(w, x.to(dtype), cfg, domain, rows)
        if not math.isfinite(float(loss)):
            raise FloatingPointError(f"reference loss not finite: {loss}")
        out["losses"].append(float(loss))
        out["grads"].append([g.detach() for g in grads])
        out["updates"].append([update(wi, g, m, cfg["lr"], cfg["alpha"])[1]
                               for wi, g, m in zip(w, grads, mom)])
        prev = w
    return out
