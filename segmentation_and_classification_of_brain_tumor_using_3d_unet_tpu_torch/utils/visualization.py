"""Medical visualization (host-side, matplotlib + plotly-JSON-over-CDN
HTML): the port's copy of the JAX package's ``utils/visualization.py``,
as far as the web app draws — the MPR overlay, the volume dashboard and
the 3D reconstruction. The training dashboards, heatmaps and HTML report
come with the port's trainer. One difference: the overlay of a
multi-modal (D, H, W, M) volume draws its first modality, where JAX's
hands the M-channel slice to ``imshow``, which refuses it.

Re-implements the capability surface of the reference's
``ModernMedicalVisualizer`` (``utils/visualization.py:24-461``) without a
plotly python dependency: interactive figures are emitted as standalone
HTML that embeds the figure JSON and loads plotly.js from its CDN.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Dict

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
# volumetric visualizations (reference utils/visualization.py)
# ---------------------------------------------------------------------------

class ModernMedicalVisualizer:
    """The pictures of one analysed upload (the reference class's
    ``utils/visualization.py:24-461`` methods the app calls)."""

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
