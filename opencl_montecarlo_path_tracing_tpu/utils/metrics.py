"""Image-quality metrics for golden-render validation (SURVEY.md section 4:
RMSE vs SimpleCPUTracer; spp to fixed RMSE)."""

from __future__ import annotations

import numpy as np


def rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean()))


def rmse_u8(a, b) -> float:
    """RMSE in 8-bit units (0..255 scale)."""
    return rmse(a, b)


def correlation(a, b) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.corrcoef(a, b)[0, 1])


def psnr(a, b, peak: float = 255.0) -> float:
    r = rmse(a, b)
    return float("inf") if r == 0 else 20.0 * np.log10(peak / r)


def spp_to_rmse(render_at_spp, reference_img, target: float,
                spp_schedule=(16, 32, 64, 128, 256, 512, 1024, 2048)):
    """Smallest spp from the schedule whose render reaches RMSE <= target
    against ``reference_img``; returns (spp or None, history)."""
    history = []
    for spp in spp_schedule:
        img = np.asarray(render_at_spp(spp))
        r = rmse(img, reference_img)
        history.append((spp, r))
        if r <= target:
            return spp, history
    return None, history


def film_agreement(a, b, rel: float = 1e-4) -> dict:
    """How closely film ``a`` matches film ``b`` (both (H, W, 3)):
    ``within`` is the share of pixels whose largest channel difference
    is at most ``rel`` times the largest magnitude in ``b``;
    ``mean_rel`` is the relative difference of the film means."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = float(np.abs(b).max())
    d = np.abs(a - b).max(axis=-1)
    mb = float(b.mean())
    return {"within": float((d <= rel * scale).mean()),
            "mean_rel": abs(float(a.mean()) - mb) / max(abs(mb), 1e-30),
            "max_abs": float(d.max()), "scale": scale}


def rgba8_agreement(a, b, tol: int = 1) -> float:
    """Share of pixels whose RGBA8 channels all differ by at most ``tol``."""
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return float((d.max(axis=-1) <= tol).mean())
