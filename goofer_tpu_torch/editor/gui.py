"""Interactive voicing editor (tkinter front-end): the port of
goofer_tpu/editor/gui.py.

Functional equivalent of SillyEditor (ref: SillyEditor.py:11-502,566-637):
a waveform canvas with per-sample voicing painting (LMB voiced, RMB/MMB
unvoiced — ref :459-490; mode via keys 1/2/3 or the "Editing:" combobox,
ref :96-103), zoom + scroll, an F0 brush slider (50-500 Hz),
preview synthesis through the port's synth on the device (the pulse
kernel on CUDA), and atomic `.goofy` write-back.  All stateful editing
semantics live in goofer_tpu_torch.editor.core; this module is only the
event loop + drawing, and imports tkinter lazily so headless
environments can use everything else.

Two differences from goofer_tpu, both deliberate: a preview renders at
the span's exact length (eager PyTorch takes any length; goofer_tpu's
length bucket bounds XLA compiles and attenuates its last n_fft
samples), and the UI slices features at the hop it is given where
goofer_tpu's hard-codes 256.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from goofer_tpu_torch import config
from goofer_tpu_torch.editor.core import (
    apply_f0_brush,
    fill_f0_for_painted_voicing,
    paint_mask_span,
)
from goofer_tpu_torch.io.goofy import load_features, save_features_atomic
from goofer_tpu_torch.utils.audio_io import AUDIO_EXTS, read_wav_mono

log = logging.getLogger("goofer_tpu_torch")


def _preview_synthesis(env_dense, f0, mask, forms, sr,
                       n_fft=config.SAMPLER_N_FFT, hop=config.SAMPLER_HOP,
                       device=None) -> np.ndarray:
    """Render a preview of (a span of) the features at 0.5 gain
    (ref: SillyEditor.py:555-563) on ``device`` (None:
    config.get_device()): one synthesis pass at the span's length, the
    three stems summed on the device and copied to the host once."""
    from goofer_tpu_torch.engine.synth import SynthStatic, synthesize

    n = len(mask)
    tracks = np.stack([
        np.asarray(forms.get(i, np.zeros(env_dense.shape[1])))
        for i in (1, 2, 3, 4)]).astype(np.float32)
    if tracks.shape[1] != env_dense.shape[1]:
        t = env_dense.shape[1]
        tracks = (np.pad(tracks, ((0, 0), (0, max(0, t - tracks.shape[1]))),
                         mode="edge")[:, :t])
    mask = np.asarray(mask, dtype=np.float32)
    f0 = mask * np.maximum(np.asarray(f0, dtype=np.float32), 0.0)
    st = SynthStatic(sr=sr, n_fft=n_fft, hop=hop, n=n)
    _, harm, uv, bre = synthesize(
        st, np.asarray(env_dense, dtype=np.float32), f0, mask, tracks,
        knobs={"n_true": float(n)}, device=device)
    return ((harm + uv + bre) * 0.5).cpu().numpy()


class VoicingEditorUI:
    """Canvas editor; see module docstring."""

    def __init__(self, parent, y, sr, init_mask=None,
                 title="Voicing Editor", features=None,
                 n_fft=config.SAMPLER_N_FFT, hop=config.SAMPLER_HOP,
                 device=None):
        import tkinter as tk
        from tkinter import ttk

        self.tk = tk
        self.n_fft = n_fft
        self.hop = hop    # the frame step of the features' env and formants
        self.device = device
        self.y = np.asarray(y, dtype=np.float32)
        self.sr = int(sr)
        self.n = len(self.y)
        self.mask = (np.ones(self.n, dtype=np.float32)
                     if init_mask is None or len(init_mask) != self.n
                     else np.asarray(init_mask, dtype=np.float32))
        self.f0 = None
        self.features = features
        self.ok = False
        self.zoom = 1.0
        self.scroll = 0.0
        self._paint_anchor = None
        self.edit_mode = "both"

        self.win = tk.Toplevel(parent)
        self.win.title(title)
        self.win.geometry("970x380")
        self.win.protocol("WM_DELETE_WINDOW", self._cancel)

        main = ttk.Frame(self.win)
        main.pack(fill=tk.BOTH, expand=True)
        left = ttk.Frame(main)
        left.pack(side=tk.LEFT, fill=tk.BOTH, expand=True, padx=6, pady=6)
        self.canvas = tk.Canvas(left, bg="#101018", highlightthickness=0)
        self.canvas.pack(fill=tk.BOTH, expand=True)

        self.scrollbar = ttk.Scrollbar(left, orient=tk.HORIZONTAL,
                                       command=self._on_scroll)
        self.scrollbar.pack(side=tk.BOTTOM, fill=tk.X)
        zoom_frame = ttk.Frame(left)
        zoom_frame.pack(fill=tk.X)
        ttk.Label(zoom_frame, text="Zoom").pack(side=tk.LEFT)
        self.zoom_slider = ttk.Scale(zoom_frame, from_=1, to=20,
                                     command=self._on_zoom)
        self.zoom_slider.pack(fill=tk.X, expand=True, padx=6)

        right = ttk.Frame(main)
        right.pack(side=tk.RIGHT, fill=tk.Y, padx=8, pady=8)
        ttk.Button(right, text="Play", command=self._play).pack(fill=tk.X)
        ttk.Button(right, text="Stop", command=self._stop).pack(fill=tk.X)
        ttk.Button(right, text="Apply", command=self._ok_close).pack(
            fill=tk.X, pady=(12, 0))
        ttk.Button(right, text="Cancel", command=self._cancel).pack(
            fill=tk.X, pady=(4, 12))
        # mode combobox, widget-for-widget with the reference
        # (ref: SillyEditor.py:94-103); keys 1/2/3 stay as shortcuts
        mode_frame = ttk.Frame(right)
        mode_frame.pack(fill=tk.X)
        ttk.Label(mode_frame, text="Editing:").pack(side=tk.LEFT)
        self.mode_var = tk.StringVar(value=self.edit_mode)
        self.mode_combo = ttk.Combobox(
            mode_frame, textvariable=self.mode_var,
            values=["both", "voiced", "unvoiced"], state="readonly",
            width=12)
        self.mode_combo.pack(side=tk.LEFT, padx=6)
        self.mode_combo.configure(takefocus=False)
        self.mode_combo.bind("<FocusIn>",
                             lambda e: e.widget.selection_clear())
        self.mode_combo.bind("<<ComboboxSelected>>",
                             lambda _e: self._set_mode(self.mode_var.get()))
        ttk.Label(right, text="F0 brush (Hz)").pack()
        self.f0_var = tk.DoubleVar(value=120.0)
        self.f0_slider = ttk.Scale(right, from_=50, to=500,
                                   variable=self.f0_var)
        self.f0_slider.pack(fill=tk.X, padx=6)
        self.f0_slider.bind("<ButtonRelease-1>",
                            lambda _e: self._apply_brush())

        for k, mode in (("1", "both"), ("2", "voiced"), ("3", "unvoiced")):
            self.win.bind(k, lambda _e, m=mode: self._set_mode(m))
        self.canvas.bind("<Button-1>", lambda e: self._begin(e, True))
        self.canvas.bind("<B1-Motion>", self._motion)
        self.canvas.bind("<ButtonRelease-1>", lambda _e: self._end())
        self.canvas.bind("<Button-3>", lambda e: self._begin(e, False))
        self.canvas.bind("<B3-Motion>", self._motion)
        self.canvas.bind("<ButtonRelease-3>", lambda _e: self._end())
        # middle button paints unvoiced like RMB in "both" mode and the
        # pinned polarity in voiced/unvoiced modes — _begin dispatches on
        # edit_mode, so one binding set covers the reference's per-mode
        # _rebind_canvas (ref: SillyEditor.py:459-490)
        self.canvas.bind("<Button-2>", lambda e: self._begin(e, False))
        self.canvas.bind("<B2-Motion>", self._motion)
        self.canvas.bind("<ButtonRelease-2>", lambda _e: self._end())
        self.canvas.bind("<Configure>", lambda _e: self._draw())
        self._draw()

    # -- view ----------------------------------------------------------
    def _view_span(self):
        vis = max(200, min(self.n, int(self.n / self.zoom)))
        start = int(self.scroll * (self.n - vis))
        start = max(0, min(start, self.n - vis))
        return start, min(self.n, start + vis)

    def _set_mode(self, mode):
        self.edit_mode = mode
        self.mode_var.set(mode)      # keep the combobox in sync with 1/2/3
        self._draw()

    def _on_zoom(self, value):
        self.zoom = float(value)
        self._draw()

    def _on_scroll(self, *args):
        if args[0] == "moveto":
            self.scroll = float(np.clip(float(args[1]), 0, 1))
        elif args[0] == "scroll":
            self.scroll = float(np.clip(
                self.scroll + int(args[1]) * 0.05 / self.zoom, 0, 1))
        self._draw()

    # -- painting ------------------------------------------------------
    def _x_to_sample(self, x):
        a, b = self._view_span()
        w = max(1, self.canvas.winfo_width())
        return a + int(np.clip(x / w, 0, 1) * (b - a))

    def _begin(self, event, lmb_voiced):
        if self.edit_mode == "voiced":
            voiced = True
        elif self.edit_mode == "unvoiced":
            voiced = False
        else:
            voiced = lmb_voiced
        self._paint_anchor = (event.x, voiced)
        self._paint(event.x, event.x, voiced)

    def _motion(self, event):
        if self._paint_anchor is None:
            return
        x0, voiced = self._paint_anchor
        self._paint(x0, event.x, voiced)

    def _end(self):
        self._paint_anchor = None

    def _paint(self, x0, x1, voiced):
        a = self._x_to_sample(min(x0, x1))
        b = self._x_to_sample(max(x0, x1)) + 1
        self.mask = paint_mask_span(self.mask, a, b, voiced)
        if self.f0 is not None:
            self.f0[a:b] = float(self.f0_var.get()) if voiced else 0.0
        self._draw()

    def _apply_brush(self):
        if self.f0 is not None:
            self.f0 = apply_f0_brush(self.f0, self.mask,
                                     float(self.f0_var.get()))
            self._draw()

    def init_f0_track(self, f0_init):
        self.f0 = apply_f0_brush(np.asarray(f0_init, dtype=np.float32),
                                 self.mask, float(self.f0_var.get()))

    # -- audio ---------------------------------------------------------
    def _play(self):
        try:
            import sounddevice as sd
        except Exception:
            log.warning("[PLAYBACK] sounddevice unavailable")
            return
        try:
            a, b = self._view_span()
            if self.features is not None:
                env, f0i, _vm, forms, sr0, _ylen = self.features
                f0_src = self.f0 if self.f0 is not None else f0i
                f0_seg = fill_f0_for_painted_voicing(
                    np.asarray(f0_src[a:b]), self.mask[a:b],
                    np.asarray(f0i), (a + b) // 2)
                hop = self.hop
                env_seg = np.asarray(env)[:, a // hop:
                                          max(a // hop + 1, -(-b // hop))]
                forms_seg = {k: np.asarray(v)[a // hop:
                                              max(a // hop + 1, -(-b // hop))]
                             for k, v in forms.items()}
                y_play = _preview_synthesis(env_seg, f0_seg, self.mask[a:b],
                                            forms_seg, sr0, self.n_fft, hop,
                                            device=self.device)
            else:
                y_play = self.y[a:b]
            sd.stop()
            sd.play(y_play.astype(np.float32), self.sr)
        except Exception as e:
            log.warning("[PLAYBACK] Failed to play: %s", e)

    def _stop(self):
        try:
            import sounddevice as sd
            sd.stop()
        except Exception:
            pass

    # -- lifecycle -----------------------------------------------------
    def _ok_close(self):
        self.ok = True
        self._stop()
        self.win.destroy()

    def _cancel(self):
        self.ok = False
        self._stop()
        self.win.destroy()

    # -- drawing -------------------------------------------------------
    def _draw(self):
        c = self.canvas
        c.delete("all")
        w = c.winfo_width() or 800
        h = c.winfo_height() or 220
        a, b = self._view_span()
        idx = np.linspace(a, b - 1, min(b - a, w)).astype(int)
        mask_ds = self.mask[idx]
        # voicing background
        runs = np.flatnonzero(np.diff(np.concatenate(
            [[-1], mask_ds, [-1]])) != 0)
        for i in range(len(runs) - 1):
            x0 = runs[i] * w / len(idx)
            x1 = runs[i + 1] * w / len(idx)
            color = "#00bfff" if mask_ds[runs[i]] > 0.5 else "#2a2a2a"
            c.create_rectangle(x0, 0, x1, h, outline="", fill=color)
        # waveform
        seg = self.y[idx]
        peak = float(np.max(np.abs(seg))) or 1.0
        ys = (0.5 - 0.45 * seg / peak) * h
        pts = []
        for i, yv in enumerate(ys):
            pts.extend([i * w / len(idx), yv])
        if len(pts) >= 4:
            c.create_line(*pts, fill="#e6f7ff", width=1)
        c.create_text(
            8, 12, anchor="w", fill="#ffffff",
            text=(f"mode={self.edit_mode} (1/2/3) | "
                  f"{a / self.sr:.2f}s-{b / self.sr:.2f}s | "
                  f"zoom={self.zoom:.1f}x"))
        page = (b - a) / self.n
        self.scrollbar.set(self.scroll, min(1.0, self.scroll + page))


def available_interactive_hook():
    """Return ``interactive_voicing`` when a blocking GUI editor can
    actually open (tkinter importable + a display present), else None.

    This is the production default ``editor_hook`` for the CLI/server
    (ref: SillySampler.py:581-611 unconditionally blocks on the tkinter
    editor during a render when the SE flag is set; headless
    environments get a logged skip instead of a crash)."""
    import os
    import sys

    if sys.platform not in ("win32", "darwin") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return None
    try:
        import tkinter  # noqa: F401
    except Exception:  # pragma: no cover - tkinter always importable here
        return None
    return interactive_voicing


def interactive_voicing(y_snippet, sr, init_mask=None,
                        title="Voicing Editor"):
    """Modal editor; returns the edited mask or None on cancel
    (ref: SillyEditor.py:492-502)."""
    import tkinter as tk

    root = tk.Tk()
    root.withdraw()
    ui = VoicingEditorUI(root, y_snippet, sr, init_mask=init_mask,
                         title=title)
    root.wait_window(ui.win)
    out = ui.mask.astype(np.float32) if ui.ok else None
    try:
        root.destroy()
    except Exception:
        pass
    return out


def _find_neighbor_audio(goofy_path: Path):
    name = goofy_path.name
    base = (name[: -len("_features.goofy")]
            if name.endswith("_features.goofy") else goofy_path.stem)
    for ext in AUDIO_EXTS:
        cand = goofy_path.with_name(base + ext)
        if cand.exists() and cand.is_file():
            return cand
    return None


def edit_goofy_files(goofy_paths, n_fft=config.SAMPLER_N_FFT,
                     hop=config.SAMPLER_HOP, device=None):
    """Standalone `.goofy` editor batch mode (ref: SillyEditor.py:566-637).

    A knot-mode envelope is decoded, and a file without neighbouring
    audio previewed, on ``device`` (None: config.get_device())."""
    import tkinter as tk

    import torch

    from goofer_tpu_torch.ops.envelope import decode_env_from_knots

    device = config.get_device(device)
    for path_str in goofy_paths:
        p = Path(path_str)
        if not p.exists() or p.suffix.lower() != ".goofy":
            log.warning("[GOOFY] Skip non-existent or not .goofy: %s", p)
            continue
        try:
            log.info("[GOOFY] Opening %s", p.name)
            env0, f0i0, vmask0, forms0, sr0, ylen0 = load_features(str(p))
            env_dense = env0
            if isinstance(env0, dict):
                knots = torch.as_tensor(np.asarray(env0["knot_vals_log"],
                                                   dtype=np.float32),
                                        device=device)
                env_dense = decode_env_from_knots(
                    knots, env0["sr"], env0["n_fft"],
                    env0["n_bins"]).cpu().numpy()

            audio = _find_neighbor_audio(p)
            y_ui = None
            if audio is not None:
                try:
                    y_ui, sr_a = read_wav_mono(audio)
                    if sr_a != sr0:
                        n_new = int(round(len(y_ui) * sr0 / sr_a))
                        y_ui = np.interp(
                            np.linspace(0, len(y_ui) - 1, n_new),
                            np.arange(len(y_ui)), y_ui)
                except Exception as e:
                    log.warning("[GOOFY] Failed neighbor audio: %s", e)
                    y_ui = None
            if y_ui is None:
                y_ui = _preview_synthesis(
                    env_dense, np.asarray(vmask0) * np.maximum(f0i0, 0.0),
                    vmask0, forms0, sr0, n_fft, hop, device=device)

            root = tk.Tk()
            root.withdraw()
            ui = VoicingEditorUI(
                root, y_ui.astype(np.float32), sr0,
                init_mask=np.asarray(vmask0, dtype=np.float32),
                title=f"Voicing: {p.name}",
                features=(env_dense, f0i0, vmask0, forms0, sr0, ylen0),
                n_fft=n_fft, hop=hop, device=device)
            ui.init_f0_track(f0i0[:int(ylen0)])
            root.wait_window(ui.win)
            mask_out = ui.mask.astype(np.float32) if ui.ok else None
            try:
                root.destroy()
            except Exception:
                pass
            if mask_out is None:
                log.info("[GOOFY] Edit cancelled: %s", p.name)
                continue

            target = int(ylen0)

            def fit(x):
                x = np.asarray(x, dtype=np.float32)
                if len(x) > target:
                    return x[:target]
                if len(x) < target:
                    return np.pad(x, (0, target - len(x)), mode="edge")
                return x

            out_f0 = fit(ui.f0 if ui.f0 is not None else f0i0)
            save_features_atomic(p, env0, out_f0, fit(mask_out), forms0,
                                 sr0, target)
            log.info("[GOOFY] Saved edits %s", p.name)
        except Exception:
            log.exception("[GOOFY] Failed to edit %s", p)
