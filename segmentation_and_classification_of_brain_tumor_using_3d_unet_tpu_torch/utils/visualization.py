"""Medical visualization (host-side, matplotlib + plotly-JSON-over-CDN
HTML): the port's copy of the JAX package's ``utils/visualization.py`` —
the web app's pictures (the MPR overlay, the volume dashboard, the 3D
reconstruction), the trainer's dashboards (PNG and interactive HTML),
the Dice analysis, the confusion heatmap, the HTML medical report and
the slice comparison. One difference: the overlay of a multi-modal
(D, H, W, M) volume draws its first modality, where JAX's hands the
M-channel slice to ``imshow``, which refuses it.

Re-implements the capability surface of the reference's
``ModernMedicalVisualizer`` (``utils/visualization.py:24-461``) without a
plotly python dependency: interactive figures are emitted as standalone
HTML that embeds the figure JSON and loads plotly.js from its CDN.
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import BRATS_COLORS, CLASS_NAMES

# matplotlib in headless mode
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

_CLASS_RGBA = {
    1: (0.91, 0.30, 0.24, 0.55),   # necrotic - red
    2: (0.95, 0.77, 0.06, 0.55),   # edema - yellow
    3: (0.20, 0.60, 0.86, 0.55),   # enhancing - blue
}


def _fig_to_base64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    plt.close(fig)
    return ("data:image/png;base64,"
            + base64.b64encode(buf.getvalue()).decode())


def plotly_html(figure_json: Dict, title: str = "Figure") -> str:
    """Standalone HTML embedding a plotly figure (no python plotly dep)."""
    payload = json.dumps(figure_json)
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{title}</title>
<script src="https://cdn.plot.ly/plotly-2.32.0.min.js"></script></head>
<body><div id="fig" style="width:100%;height:92vh;"></div>
<script>var f = {payload}; Plotly.newPlot('fig', f.data, f.layout);</script>
</body></html>"""


# ---------------------------------------------------------------------------
# training dashboards and analysis (the trainer's report)
# ---------------------------------------------------------------------------

def create_training_dashboard(history: Dict[str, Sequence[float]],
                              save_path: Optional[str] = None) -> str:
    """2x2 loss/dice/LR/HD dashboard; returns base64 PNG (and saves)."""
    epochs = range(1, len(history.get("train_loss", [])) + 1)
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    ax = axes[0, 0]
    ax.plot(epochs, history["train_loss"], label="train")
    if history.get("val_loss"):
        ax.plot(epochs, history["val_loss"], label="val")
    ax.set_title("Loss"); ax.set_xlabel("epoch"); ax.legend()
    ax = axes[0, 1]
    ax.plot(epochs, history.get("train_dice", []), label="train")
    if history.get("val_dice"):
        ax.plot(epochs, history["val_dice"], label="val")
    ax.set_title("Dice"); ax.set_xlabel("epoch"); ax.legend()
    ax = axes[1, 0]
    ax.plot(epochs, history.get("learning_rates", []))
    ax.set_title("Learning rate"); ax.set_yscale("log")
    ax = axes[1, 1]
    hd = [h for h in history.get("val_hausdorff", [])
          if h == h and np.isfinite(h)]
    if hd:
        ax.plot(range(1, len(hd) + 1), hd)
    ax.set_title("Val HD95 (mm)")
    fig.suptitle("Training dashboard")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return _fig_to_base64(fig)


def create_training_dashboard_html(history: Dict[str, Sequence[float]],
                                   save_path: Optional[str] = None
                                   ) -> str:
    """Interactive plotly 2x2 training dashboard (loss / dice / LR /
    val HD95) as standalone HTML — the interactive counterpart of the
    PNG dashboard, matching the reference's plotly training report
    (``training.py:416-466``). Figure JSON is embedded directly
    (plotly.js from CDN via ``plotly_html``); no python plotly dep."""
    n = len(history.get("train_loss", []))
    epochs = list(range(1, n + 1))

    def trace(ys, name, axis, **kw):
        return {"type": "scatter", "mode": "lines", "name": name,
                "x": epochs[:len(ys)], "y": [float(v) for v in ys],
                "xaxis": f"x{axis}", "yaxis": f"y{axis}", **kw}

    data = [trace(history.get("train_loss", []), "train loss", 1),
            trace(history.get("val_loss", []), "val loss", 1),
            trace(history.get("train_dice", []), "train dice", 2),
            trace(history.get("val_dice", []), "val dice", 2),
            trace(history.get("learning_rates", []), "lr", 3)]
    hd = [float(h) for h in history.get("val_hausdorff", [])
          if h == h and np.isfinite(h)]
    data.append(trace(hd, "val HD95 (mm)", 4))
    layout = {
        "title": {"text": "Training dashboard (interactive)"},
        "grid": {"rows": 2, "columns": 2, "pattern": "independent"},
        "xaxis": {"title": {"text": "epoch"}},
        "xaxis2": {"title": {"text": "epoch"}},
        "xaxis3": {"title": {"text": "epoch"}},
        "xaxis4": {"title": {"text": "epoch"}},
        "yaxis": {"title": {"text": "loss"}},
        "yaxis2": {"title": {"text": "dice"}},
        "yaxis3": {"title": {"text": "learning rate"},
                   "type": "log"},
        "yaxis4": {"title": {"text": "HD95 (mm)"}},
    }
    html = plotly_html({"data": data, "layout": layout},
                       "Training dashboard")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as f:
            f.write(html)
    return html


def create_dice_analysis(history: Dict[str, Sequence[float]],
                         save_path: Optional[str] = None) -> str:
    """Dice histogram / moving average / summary (reference
    ``training.py:468-515``)."""
    dice = list(history.get("val_dice", []))
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    if dice:
        axes[0, 0].hist(dice, bins=20, color="#3498db")
        axes[0, 0].set_title("Val Dice distribution")
        w = max(1, len(dice) // 10)
        ma = np.convolve(dice, np.ones(w) / w, mode="valid")
        axes[0, 1].plot(ma)
        axes[0, 1].set_title(f"Moving average (w={w})")
        axes[1, 0].plot(dice)
        axes[1, 0].set_title("Val Dice per epoch")
        txt = (f"best: {max(dice):.4f}\nfinal: {dice[-1]:.4f}\n"
               f"mean: {np.mean(dice):.4f}\nepochs: {len(dice)}")
        axes[1, 1].text(0.2, 0.4, txt, fontsize=14, family="monospace")
    axes[1, 1].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return _fig_to_base64(fig)


# ---------------------------------------------------------------------------
# volumetric visualizations (reference utils/visualization.py)
# ---------------------------------------------------------------------------

class ModernMedicalVisualizer:
    """The pictures of one analysed upload, the training dashboard, the
    confusion heatmap and the HTML report (the reference class's
    ``utils/visualization.py:24-461``)."""

    def create_segmentation_overlay(self, volume: np.ndarray,
                                    segmentation: np.ndarray) -> str:
        """2x3 MPR grid: original + per-class RGBA overlay + legend
        (reference ``utils/visualization.py:96-151``)."""
        v, s = np.asarray(volume), np.asarray(segmentation)
        if v.ndim == s.ndim + 1:     # (D, H, W, M): the first modality
            v = v[..., 0]
        mids = [d // 2 for d in v.shape]
        planes = [(v[mids[0]], s[mids[0]]), (v[:, mids[1]], s[:, mids[1]]),
                  (v[:, :, mids[2]], s[:, :, mids[2]])]
        fig, axes = plt.subplots(2, 3, figsize=(13, 8))
        titles = ["axial", "sagittal", "coronal"]
        for c, (pv, ps) in enumerate(planes):
            axes[0, c].imshow(pv.T, cmap="gray", origin="lower")
            axes[0, c].set_title(f"{titles[c]} (original)")
            axes[1, c].imshow(pv.T, cmap="gray", origin="lower")
            overlay = np.zeros((*pv.T.shape, 4))
            for cls, rgba in _CLASS_RGBA.items():
                overlay[ps.T == cls] = rgba
            axes[1, c].imshow(overlay, origin="lower")
            axes[1, c].set_title(f"{titles[c]} (overlay)")
        for a in axes.ravel():
            a.axis("off")
        handles = [plt.Rectangle((0, 0), 1, 1, color=_CLASS_RGBA[c][:3])
                   for c in _CLASS_RGBA]
        fig.legend(handles, [CLASS_NAMES[c] for c in _CLASS_RGBA],
                   loc="lower center", ncol=3)
        return _fig_to_base64(fig)

    def create_3d_tumor_reconstruction(self, segmentation: np.ndarray,
                                       min_voxels: int = 100,
                                       max_voxels: int = 200_000) -> str:
        """Per-class isosurface -> plotly Mesh3d HTML (capability parity
        with reference ``utils/visualization.py:153-209``; skips classes
        < min_voxels). Uses the smooth marching-tetrahedra mesher
        (marching-cubes-quality surfaces, not blocky voxel faces).
        Classes above ``max_voxels`` are meshed at reduced resolution so
        a degenerate (speckled) segmentation cannot stall an upload
        response for minutes of host meshing."""
        from .mesh import smooth_surface_mesh
        seg = np.asarray(segmentation)
        data = []
        for cls in (1, 2, 3):
            mask = seg == cls
            if mask.sum() < min_voxels:
                continue
            verts, faces = smooth_surface_mesh(mask, max_voxels=max_voxels)
            if len(faces) == 0:
                continue
            data.append({
                "type": "mesh3d",
                "x": verts[:, 0].tolist(), "y": verts[:, 1].tolist(),
                "z": verts[:, 2].tolist(),
                "i": faces[:, 0].tolist(), "j": faces[:, 1].tolist(),
                "k": faces[:, 2].tolist(),
                "color": BRATS_COLORS[cls], "opacity": 0.55,
                "name": CLASS_NAMES[cls],
            })
        fig_json = {"data": data, "layout": {
            "title": "3D tumor reconstruction",
            "scene": {"aspectmode": "data"}}}
        return plotly_html(fig_json, "3D tumor reconstruction")

    def create_volume_analysis_dashboard(self, volume: np.ndarray,
                                         segmentation: np.ndarray
                                         ) -> str:
        """Pie/per-slice/intensity dashboard (reference
        ``utils/visualization.py:211-313``), matplotlib edition."""
        v, s = np.asarray(volume), np.asarray(segmentation)
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        counts = [int((s == c).sum()) for c in (1, 2, 3)]
        if sum(counts):
            axes[0, 0].pie([c for c in counts if c], labels=[
                CLASS_NAMES[i + 1] for i, c in enumerate(counts) if c],
                autopct="%1.1f%%")
        axes[0, 0].set_title("Tumor composition")
        axes[0, 1].plot((s > 0).sum(axis=(1, 2)))
        axes[0, 1].set_title("Tumor area per slice")
        axes[1, 0].hist(v[s > 0].ravel() if (s > 0).any() else v.ravel(),
                        bins=50)
        axes[1, 0].set_title("Tumor intensity histogram")
        axes[1, 1].hist(v.ravel(), bins=50, color="#888")
        axes[1, 1].set_title("Volume intensity histogram")
        fig.tight_layout()
        return _fig_to_base64(fig)

    def create_training_dashboard(self, history, save_path=None) -> str:
        return create_training_dashboard(history, save_path)

    def create_performance_heatmap(self, confusion, *, class_names=None,
                                   save_path: Optional[str] = None) -> str:
        """Confusion-matrix heatmap(s). Accepts one matrix or a list of
        per-class matrices rendered side-by-side with titled panels
        (matching the reference's multi-panel seaborn layout,
        ``utils/visualization.py:366-380``); seaborn's annotated
        styling when available, plain matplotlib otherwise."""
        if isinstance(confusion, (list, tuple)):
            cms = [np.asarray(c, np.float64) for c in confusion]
        else:
            cms = [np.asarray(confusion, np.float64)]
        if class_names is None:
            class_names = [None] * len(cms)
        fig, axes = plt.subplots(1, len(cms),
                                 figsize=(5.5 * len(cms), 4.5))
        if len(cms) == 1:
            axes = [axes]
        for ax, cm, name in zip(axes, cms, class_names):
            try:
                import seaborn as sns
                sns.heatmap(cm, annot=True, fmt=".0f", cmap="Blues",
                            cbar=True, square=True, ax=ax)
            except ImportError:
                im = ax.imshow(cm, cmap="Blues")
                for i in range(cm.shape[0]):
                    for j in range(cm.shape[1]):
                        ax.text(j, i, f"{cm[i, j]:.0f}",
                                ha="center", va="center")
                ax.set_xticks(range(cm.shape[1]))
                ax.set_yticks(range(cm.shape[0]))
                fig.colorbar(im, ax=ax)
            if name:
                ax.set_title(f"{name} Confusion Matrix")
            ax.set_xlabel("Predicted"); ax.set_ylabel("Actual")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=130, bbox_inches="tight")
        return _fig_to_base64(fig)

    def save_visualization(self, content: str, path: str) -> str:
        """html/png dispatch (reference ``utils/visualization.py:382-395``)."""
        if content.startswith("data:image/png;base64,"):
            with open(path, "wb") as f:
                f.write(base64.b64decode(content.split(",", 1)[1]))
        else:
            with open(path, "w") as f:
                f.write(content)
        return path

    def generate_medical_report(self, analysis: Dict,
                                save_path: Optional[str] = None) -> str:
        """Self-contained HTML report (reference
        ``utils/visualization.py:397-461``)."""
        rows = "".join(
            f"<tr><td>{k}</td><td>{v}</td></tr>"
            for k, v in analysis.get("measurements", {}).items())
        imgs = "".join(
            f'<img src="{src}" style="max-width:100%;margin:8px 0;">'
            for src in analysis.get("images", []))
        html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Medical Analysis Report</title>
<style>body{{font-family:sans-serif;max-width:900px;margin:2em auto}}
table{{border-collapse:collapse}}td{{border:1px solid #ccc;padding:6px}}
h1{{color:#2c3e50}}</style></head><body>
<h1>Brain Tumor Analysis Report</h1>
<p><b>Classification:</b> {analysis.get('classification', 'n/a')}</p>
<p><b>Risk level:</b> {analysis.get('risk_level', 'n/a')}</p>
<table>{rows}</table>
{imgs}
<p style="color:#888">Generated by the brain tumor framework.
Research use only — not for clinical diagnosis.</p>
</body></html>"""
        if save_path:
            with open(save_path, "w") as f:
                f.write(html)
        return html


def create_modern_colormap():
    """(reference ``utils/visualization.py:464-468``)"""
    from matplotlib.colors import ListedColormap
    return ListedColormap(["#000000", "#e74c3c", "#f1c40f", "#3498db"])


def plot_slice_comparison(vol_a: np.ndarray, vol_b: np.ndarray,
                          axis: int = 0, index: Optional[int] = None,
                          save_path: Optional[str] = None) -> str:
    """(reference ``utils/visualization.py:470-490``)"""
    a, b = np.asarray(vol_a), np.asarray(vol_b)
    index = index if index is not None else a.shape[axis] // 2
    sa = np.take(a, index, axis=axis)
    sb = np.take(b, index, axis=axis)
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    axes[0].imshow(sa.T, cmap="gray", origin="lower")
    axes[0].set_title("A")
    axes[1].imshow(sb.T, cmap="gray", origin="lower")
    axes[1].set_title("B")
    for ax in axes:
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=130, bbox_inches="tight")
    return _fig_to_base64(fig)
