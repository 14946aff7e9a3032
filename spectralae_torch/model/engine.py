"""Interactive engine: the reference's control loop as a stateful runtime.

Port of :mod:`spectralae.model.engine`.  Maps the reference application's
main loop and its 24 keyboard commands (source/autoencoder.cpp:121-492,
README.md:41-67) onto the functional core: each command is a method; the
per-frame ``step`` runs the forward pass in the selected domain on the
engine's device and, when training is armed, the matching train step.

On the card a frame goes through the hand-written kernels: K1 for the six
spectral convs of a fft forward (six more when :meth:`Engine.current_views`
recomputes the activation tape), K3 twice in a fft training burst (the
correlation-space burst, anchored on the frame's reconstruction), K2 for
the 3→10 and 10→3 convs of a coordinate forward.  On the CPU the same calls
take the plain versions and the ω-space burst, as the JAX package does off
its accelerator.

Random draws ('e', 'n', and the initial weights) come from the engine's CPU
``torch.Generator`` seeded by ``seed``, so an engine on the card and one on
the CPU given the same seed and keys hold the same weights.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core import config as cfgmod
from ..core.config import Config, LayerParams
from ..core.types import (AEParams, ConvStage, NetSpec, initial_spec,
                          init_params, init_stage)
from ..io import checkpoint as ckpt
from ..ops import coord as coord_ops
from ..train.coord import coord_step
from ..train.fft import zero_moms
from ..train.fft_pallas import auto_burst
from . import autoencoder as model


def _host(t: torch.Tensor) -> np.ndarray:
    """One displayed tensor, fetched to the host."""
    return t.detach().cpu().numpy()


def _displayable(t: torch.Tensor) -> np.ndarray:
    """[C, W, H] activation → uint8 frame: the first 3 channels when C ≥ 3,
    else channel 0 broadcast to gray (inner pairs have C = M channels; the
    codec itself is strictly 3-channel).  Only the shown channels leave the
    device."""
    from ..data import pipeline
    if t.shape[0] >= 3:
        return pipeline.tensor_to_frame(np.ascontiguousarray(_host(t[:3])))
    return pipeline.tensor_to_frame(
        np.ascontiguousarray(np.repeat(_host(t[:1]), 3, axis=0)))


@dataclasses.dataclass
class EngineFlags:
    """The reference's keyboard-mutable runtime state
    (source/autoencoder.cpp:85-96)."""

    sel: bool = False          # '1' training armed
    q: int = 1                 # '2'/'3' training patch factor
    lr: float = 0.2            # '4'/'5' learning rate (del)
    dlr: float = 0.1           # log-scaled lr step (ddel)
    alpha: float = 0.9         # '6'/'7' inertia
    active: bool = False       # '9' adaptive lr — the reference flag is dead
                               # code (del=delmax re-applied, backproplib.cu:34)
                               # so its *effective* behavior is off; here the
                               # intended |Δw/Δg| rule is real and reachable,
                               # defaulting off to match effective parity
    feat: int = 0              # 'q'/'w' displayed feature map
    n_l: int = 0               # 'z'/'x' selected stage pair
    gpu: bool = True           # '0' the reference's gpu toggle → its tap
                               # window (the tensors stay on the device)
    sym: bool = False          # 'p' symmetric weights
    fft: bool = True           # 'f' momentum-space mode
    fft_l: bool = False        # 'g' per-layer inverse-FFT viz
    maxdiff: bool = False      # 'm' multiobjective diversity


class Engine:
    """Stateful autoencoder runtime (the reference's ``main`` as a library).

    ``device``: where the weights live and every frame is computed
    (default ``"cuda"``).  Asking for CUDA where torch finds none raises;
    the engine never carries on on the CPU unasked.
    """

    def __init__(self, cfg: Config | None = None, *, seed: int | None = 0,
                 param_file: str | Path | None = None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): torch finds no CUDA "
                               "device (pass device='cpu' to run on the CPU)")
        if param_file is not None:
            layer = cfgmod.load_layer_params(param_file)
            cfg = (cfg or Config()).replace(layer=layer)
        self.cfg = cfg or Config()
        self.param_file = Path(param_file) if param_file else None
        self.flags = EngineFlags(lr=self.cfg.lr, alpha=self.cfg.alpha,
                                 q=self.cfg.q, sym=self.cfg.sym,
                                 maxdiff=self.cfg.maxdiff)
        self._gen = torch.Generator().manual_seed(
            seed if seed is not None else int(np.random.randint(2**31)))
        self.spec: NetSpec = initial_spec(self.cfg)
        self.params: AEParams = init_params(self._gen, self.spec,
                                            self.cfg.layer.rmax,
                                            device=self.device)
        self._reset_pair_opt_state()
        self.layers: list | None = None  # activation tape of the last step
        self._last_x = None              # last frame, for lazy view recompute
        self.freq_cache: list | None = None  # parity stub, see clear_freq_cache
        self.last_mse: float | None = None
        self.step_count = 0

    # ------------------------------------------------------------- internals

    def _init_stage(self, spec, rmax: float) -> ConvStage:
        return init_stage(self._gen, spec, rmax, device=self.device)

    def _reset_pair_opt_state(self):
        """Zero the optimizer state for the selected pair — the reference
        re-zeroes dc/df/ddc/ddf whenever the focus layer changes
        (autoencoder.cpp:279-310)."""
        enc, dec = self.params.pair(self.flags.n_l)
        self._mom = zero_moms(enc.c, dec.c, enc.b, dec.b)
        self._prev_grad = zero_moms(*self._mom)
        self._mom_pair = self.flags.n_l

    def _coord_tap(self) -> str:
        """gpu toggle selects which reference tap window the coord path uses
        (the reference's CPU and GPU convs genuinely differ — SURVEY.md §7);
        an explicit Config.tap_mode overrides both."""
        if self.cfg.tap_mode != "centered":
            return self.cfg.tap_mode
        return "ref_gpu" if self.flags.gpu else "ref_cpu"

    def _fwd_fft(self, x, return_layers: bool):
        return model.forward_fft(self.params, x, self.spec.scales,
                                 scale_by_dm=self.cfg.scale_by_dm,
                                 return_layers=return_layers)

    # ------------------------------------------------------------- main loop

    @torch.no_grad()
    def step(self, frame, *, need_tape: bool = False) -> np.ndarray:
        """One main-loop iteration on a ``[D, Nx, Ny]`` frame (numpy or a
        tensor).

        Runs the forward pass (selected domain) on the engine's device,
        then a train step when armed.  Returns the reconstruction as a
        numpy array.  ``need_tape=True`` computes the activation tape in
        the same forward when the caller will render views every frame
        (TUI) — otherwise the fast path skips it and ``current_views``
        recomputes lazily.  Reference: the while loop body,
        autoencoder.cpp:121-205.
        """
        x = (frame.detach() if isinstance(frame, torch.Tensor)
             else torch.from_numpy(np.asarray(frame)))
        x = x.to(self.device, torch.float32, copy=True)[None]
        f = self.flags
        self._last_x = x
        if f.fft:
            # per-layer inverse FFTs cost an irfft2 per stage; only pay the
            # tax when training/viz needs the tape (the reference gates the
            # same work on fft_l, fft_backproplib.cu:1347-1361)
            if f.sel or f.fft_l or need_tape:
                out, self.layers = self._fwd_fft(x, True)
            else:
                out = self._fwd_fft(x, False)
                self.layers = None
        else:
            self.layers = model.forward_coord(
                self.params, x, self.spec.scales, tap_mode=self._coord_tap(),
                scale_by_dm=self.cfg.scale_by_dm)
            out = self.layers[-1]
        if f.sel:
            self._train()
        self.step_count += 1
        return _host(out[0])

    def select_layer(self, n_l: int):
        """Set the training-focus pair, resetting per-pair optimizer state
        (the 'z'/'x' semantics for direct assignment)."""
        self.flags.n_l = n_l % self.spec.n_pairs
        self.flags.feat = 0
        self._reset_pair_opt_state()

    def _train(self):
        f = self.flags
        n_l = f.n_l
        enc0, _ = self.params.pair(n_l)
        if self._mom_pair != n_l or self._mom[0].shape != enc0.c.shape:
            # focus pair changed without going through select_layer — the
            # pair-index check matters when two pairs share kernel shapes
            # (inner layers of an M-uniform net), where a shape test alone
            # would silently apply one pair's momentum to another; the
            # shape test still catches add/drop_layer reshaping the
            # SELECTED pair in place
            self._reset_pair_opt_state()
        in_full = self.layers[2 * n_l + 1][0]
        hin_full = self.layers[2 * n_l + 2][0]
        out_full = self.layers[len(self.layers) - 2 - 2 * n_l][0]
        in_s = coord_ops.center_crop(in_full, f.q)
        hin_s = coord_ops.center_crop(hin_full, f.q)
        out_s = coord_ops.center_crop(out_full, f.q)
        enc, dec = self.params.pair(n_l)
        if f.fft and f.gpu:
            # one burst per arm, then disarm (autoencoder.cpp:194-197);
            # like the reference, the fft burst requires gpu==1 — with gpu
            # off training falls through to the CPU coordinate backprop and
            # stays armed (autoencoder.cpp:182-200)
            res = auto_burst(in_s, None, out_s, enc.c, dec.c, enc.b, dec.b,
                             lr=f.lr, alpha=f.alpha,
                             iters=self.cfg.fft_iters, maxdiff=f.maxdiff,
                             w0=self.cfg.maxdiff_w0, w1=self.cfg.maxdiff_w1,
                             scale_by_dm=self.cfg.scale_by_dm)
            self.last_mse = float(res.mses[-1])
            f.sel = False
        else:
            # the CPU reference path (gpu off) is plain normalized-gradient
            # SGD with no inertia term (netlib.cpp:437-443) — alpha=0
            alpha = f.alpha if f.gpu else 0.0
            res = coord_step(in_s, out_s, hin_s, enc.c, dec.c, enc.b, dec.b,
                             self._mom, self._prev_grad, lr=f.lr,
                             alpha=alpha, tap_mode=self._coord_tap(),
                             sym=f.sym, active=f.active)
            self._mom, self._prev_grad = res.mom, res.prev_grad
            self.last_mse = float(res.mse)
        self.params = self.params.replace_pair(
            n_l, ConvStage(c=res.c, b=res.b), ConvStage(c=res.f, b=res.p))
        self.clear_freq_cache(quiet=True)

    # ----------------------------------------------------- keyboard commands

    def toggle_training(self):                       # '1'
        self.flags.sel = not self.flags.sel
        return self.flags.sel

    def patch_smaller(self):                         # '2'
        # cap q so the selected pair's training crop stays >= 1 px (the
        # reference increments unbounded and degenerates; quirk-fixed like
        # the pooling-divisibility guard)
        nx, ny = self.spec.nx, self.spec.ny
        for sc in self.spec.scales[: self.flags.n_l + 1]:
            if sc > 1:
                nx, ny = nx // sc, ny // sc
        if min(nx, ny) // (self.flags.q + 1) >= 1:
            self.flags.q += 1
        return self.flags.q

    def patch_larger(self):                          # '3'
        self.flags.q = max(1, self.flags.q - 1)
        return self.flags.q

    def lr_up(self):                                 # '4'
        """Log-scaled lr stepping (autoencoder.cpp:250-259)."""
        f = self.flags
        f.lr += f.dlr
        if 0.1 < f.lr < 1:
            f.dlr = 0.1
        if 0.01 < f.lr < 0.1:
            f.dlr = 0.01
        if 0.001 < f.lr < 0.01:
            f.dlr = 0.001
        if 0.0001 < f.lr < 0.001:
            f.dlr = 0.0001
        f.lr = min(f.lr, 1.0)
        return f.lr

    def lr_down(self):                               # '5'
        f = self.flags
        f.lr -= f.dlr
        if 0.1 < f.lr <= 1:
            f.dlr = 0.1
        if 0.01 < f.lr <= 0.11:
            f.dlr = 0.01
        if 0.001 < f.lr <= 0.011:
            f.dlr = 0.001
        if 0.0001 < f.lr <= 0.0011:
            f.dlr = 0.0001
        f.lr = max(f.lr, 0.0)
        return f.lr

    def inertia_up(self):                            # '6'
        self.flags.alpha = min(1.0, round(self.flags.alpha + 0.1, 10))
        return self.flags.alpha

    def inertia_down(self):                          # '7'
        self.flags.alpha = max(0.0, round(self.flags.alpha - 0.1, 10))
        return self.flags.alpha

    def toggle_active_lr(self):                      # '9'
        self.flags.active = not self.flags.active
        return self.flags.active

    def toggle_gpu(self):                            # '0'
        """The reference's gpu toggle: its tap window (and, with fft on,
        coordinate training at alpha 0).  Not a device switch — the
        tensors stay on the engine's device."""
        self.flags.gpu = not self.flags.gpu
        return self.flags.gpu

    def toggle_fft(self):                            # 'f'
        self.flags.fft = not self.flags.fft
        return self.flags.fft

    def toggle_fft_layers(self):                     # 'g'
        self.flags.fft_l = not self.flags.fft_l
        return self.flags.fft_l

    def next_feature(self):                          # 'q'
        m = self.params.stages[self.flags.n_l].m
        self.flags.feat = (self.flags.feat + 1) % m
        return self.flags.feat

    def prev_feature(self):                          # 'w'
        m = self.params.stages[self.flags.n_l].m
        # reference quirk reproduced: `(feat-1)>0 ? feat-1 : M-1`
        # (autoencoder.cpp:277) wraps feat==1 to M-1, so 0 is unreachable
        # going down
        f = self.flags.feat - 1
        self.flags.feat = f if f > 0 else m - 1
        return self.flags.feat

    def toggle_maxdiff(self):                        # 'm'
        self.flags.maxdiff = not self.flags.maxdiff
        return self.flags.maxdiff

    def next_layer(self):                            # 'z'
        self.flags.n_l = (self.flags.n_l + 1) % self.spec.n_pairs
        self.flags.feat = 0
        self._reset_pair_opt_state()
        return self.flags.n_l

    def prev_layer(self):                            # 'x'
        self.flags.n_l = (self.flags.n_l - 1) % self.spec.n_pairs
        self.flags.feat = 0
        self._reset_pair_opt_state()
        return self.flags.n_l

    def reinit_weights(self):                        # 'e'
        """Random re-init of the selected pair; re-reads the param file for
        rmax (autoencoder.cpp:311-326)."""
        rmax = self.cfg.layer.rmax
        if self.param_file and self.param_file.exists():
            rmax = cfgmod.load_layer_params(self.param_file).rmax
        n = self.spec.n_pairs
        enc_spec = self.spec.stages[self.flags.n_l]
        dec_spec = self.spec.stages[2 * n - 1 - self.flags.n_l]
        enc = self._init_stage(enc_spec, rmax)
        dec = self._init_stage(dec_spec, rmax)
        self.params = self.params.replace_pair(self.flags.n_l, enc, dec)
        self.clear_freq_cache(quiet=True)

    def clear_freq_cache(self, quiet: bool = False):  # 'c'
        """Parity with the reference's net_cfreq invalidation
        (autoencoder.cpp:327-331).  Kernel spectra here are recomputed each
        step, so this only drops the engine-held cache copy."""
        self.freq_cache = None

    def toggle_symmetric(self):                      # 'p'
        self.flags.sym = not self.flags.sym
        if self.flags.sym:
            self.params = model.tie_symmetric(self.params, self.flags.n_l)
        return self.flags.sym

    def save_weights(self, weights_dir="./weights"):  # 's'
        return ckpt.save_pair_conv(self.params, self.spec, self.flags.n_l,
                                   weights_dir)

    def save_checkpoint(self, path):
        """Full-network native checkpoint (beyond the reference's per-pair
        .conv files): params + structure in one manifest'd directory."""
        ckpt.save(path, self.params, self.spec,
                  extra={"step": self.step_count})

    def load_checkpoint(self, path):
        params, spec, _, extra = ckpt.load(path, device=self.device)
        self.params, self.spec = params, spec
        self.flags.n_l = 0
        self.flags.feat = 0
        self.step_count = int(extra.get("step", 0))
        self._reset_pair_opt_state()
        self.clear_freq_cache(quiet=True)

    def load_weights(self, weights_dir="./weights"):  # 'l'
        self.params = ckpt.load_pair_conv(self.params, self.spec,
                                          self.flags.n_l, weights_dir)
        self.clear_freq_cache(quiet=True)

    def add_layer(self, layer: LayerParams | None = None):  # 'n'
        """Insert a new stage pair at the net midpoint
        (autoencoder.cpp:384-431); selects it for training."""
        if layer is None:
            if self.param_file and self.param_file.exists():
                layer = cfgmod.load_layer_params(self.param_file)
            else:
                layer = self.cfg.layer
        n = self.spec.n_pairs
        new_spec = self.spec.add_pair(layer)
        enc = self._init_stage(new_spec.stages[n], layer.rmax)
        dec = self._init_stage(new_spec.stages[n + 1], layer.rmax)
        stages = (self.params.stages[:n] + (enc, dec)
                  + self.params.stages[n:])
        self.spec = new_spec
        self.params = AEParams(stages=stages)
        self.flags.n_l = n
        self.flags.feat = 0
        self._reset_pair_opt_state()
        self.clear_freq_cache(quiet=True)
        return self.spec.n_pairs

    def drop_layer(self):                            # 'd'
        """Delete the innermost stage pair (autoencoder.cpp:432-457)."""
        if self.spec.n_pairs <= 1:
            return self.spec.n_pairs
        n = self.spec.n_pairs
        self.spec = self.spec.drop_pair()
        stages = self.params.stages[: n - 1] + self.params.stages[n + 1:]
        self.params = AEParams(stages=stages)
        self.flags.n_l = 0
        self.flags.feat = 0
        self._reset_pair_opt_state()
        self.clear_freq_cache(quiet=True)
        return self.spec.n_pairs

    def info(self) -> str:                           # 'i'
        """Network-structure dump (autoencoder.cpp:458-492)."""
        lines = ["Network structure", ""]
        spec = self.spec
        n = len(spec.stages)
        cx, cy = spec.nx, spec.ny
        for i, (st, sp) in enumerate(zip(self.params.stages, spec.stages)):
            if i < n // 2:
                lines.append(f"    L={2*i} D={st.d} Nx={cx} Ny={cy}")
                lines.append(f"P={i} S={sp.scale}")
                cx, cy = cx // sp.scale, cy // sp.scale
                lines.append(f"    L={2*i+1} D={st.d} Nx={cx} Ny={cy}")
                lines.append(f"C={i} M={st.m} D={st.d} Nk={st.nk} Nl={st.nl}")
                lines.append(f"B={i} M={st.m}")
            else:
                lines.append(f"    L={2*i} D={st.d} Nx={cx} Ny={cy}")
                lines.append(f"C={i} M={st.m} D={st.d} Nk={st.nk} Nl={st.nl}")
                lines.append(f"B={i} M={st.m}")
                cx, cy = cx * (-sp.scale), cy * (-sp.scale)
                lines.append(f"    L={2*i+1} D={st.m} Nx={cx} Ny={cy}")
                lines.append(f"P={i} S={sp.scale}")
            lines.append("-" * 10)
        lines.append(f"    L={2*n} D={self.spec.d} Nx={cx} Ny={cy}")
        return "\n".join(lines)

    # --------------------------------------------------------------- display

    @torch.no_grad()
    def current_views(self) -> dict[str, np.ndarray]:
        """The four reference windows as arrays: input, output, feature map,
        kernel mosaic (autoencoder.cpp:211-242).  With 'g' (fft_l) on in fft
        mode, the per-layer inverse-FFT streams and the output spectrum are
        added (fft_backproplib.cu:1344-1361).  Only what is shown is
        fetched from the device."""
        from ..data import pipeline
        from ..ops import spectral
        from ..viz.spectrum import spectrum_image
        f = self.flags
        if self.layers is None:
            # the fast step path skips the tape (no viz tax per frame);
            # recompute it on demand for the displayed frame
            if self._last_x is None:
                raise RuntimeError("call step() first")
            _, self.layers = self._fwd_fft(self._last_x, True)
        n_l = f.n_l
        stage = self.params.stages[n_l]
        kern = _host(stage.c[f.feat])
        views = {
            "input": _displayable(self.layers[2 * n_l][0]),
            "output": _displayable(
                self.layers[len(self.layers) - 1 - 2 * n_l][0]),
            "feature_map": pipeline.feature_to_image(
                _host(self.layers[2 * n_l + 2][0][f.feat])),
            "kernel": np.concatenate(
                [pipeline.kernel_to_image(kern[d]) for d in range(stage.d)],
                axis=1),
        }
        if f.fft and f.fft_l:
            for i, layer in enumerate(self.layers):
                views[f"layer_{i}"] = pipeline.feature_to_image(
                    _host(layer[0][min(f.feat, layer.shape[1] - 1)]))
            out_t = self.layers[-1]
            mag = _host(torch.abs(spectral.rfft2(out_t[:1, :1]))[0, 0])
            views["spectrum"] = spectrum_image(mag, out_t.shape[-2],
                                               out_t.shape[-1])
        return views


KEYMAP = {
    "1": "toggle_training", "2": "patch_smaller", "3": "patch_larger",
    "4": "lr_up", "5": "lr_down", "6": "inertia_up", "7": "inertia_down",
    "9": "toggle_active_lr", "0": "toggle_gpu", "f": "toggle_fft",
    "g": "toggle_fft_layers", "q": "next_feature", "w": "prev_feature",
    "m": "toggle_maxdiff", "z": "next_layer", "x": "prev_layer",
    "e": "reinit_weights", "c": "clear_freq_cache", "p": "toggle_symmetric",
    "s": "save_weights", "l": "load_weights", "n": "add_layer",
    "d": "drop_layer", "i": "info",
}


def dispatch_key(engine: Engine, key: str):
    """Apply one reference keyboard command to the engine."""
    method = KEYMAP.get(key)
    if method is None:
        return None
    return getattr(engine, method)()
