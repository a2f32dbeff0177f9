"""Accuracy metrics for super-resolved rasters.

The reference evaluates with a single global RMSE print
(testing/demoDSen2.py:31-35, matlab_demo/RMSE.m); the companion paper (arXiv
1803.04271) reports RMSE, SRE, SAM, ERGAS and UIQ tables. All live here."""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = [
    "rmse",
    "per_band_rmse",
    "sre_db",
    "per_band_sre",
    "sam_deg",
    "ergas",
    "uiq",
    "evaluation_table",
]


def rmse(x: np.ndarray, y: np.ndarray) -> float:
    """Global root-mean-square error over all pixels/bands (float64)."""
    d = x.astype(np.float64) - y.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def per_band_rmse(sr: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[C] RMSE per band for HWC rasters."""
    d = sr.astype(np.float64) - gt.astype(np.float64)
    return np.sqrt(np.mean(d * d, axis=(0, 1)))


def sre_db(sr: np.ndarray, gt: np.ndarray) -> float:
    """Signal-to-reconstruction-error ratio in dB, mean over bands."""
    return float(np.mean(per_band_sre(sr, gt)))


def per_band_sre(sr: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[C] SRE per band: 10*log10(mean(gt^2) / mse)."""
    gt64 = gt.astype(np.float64)
    mse = np.mean((sr.astype(np.float64) - gt64) ** 2, axis=(0, 1))
    sig = np.mean(gt64 * gt64, axis=(0, 1))
    return 10.0 * np.log10(sig / np.maximum(mse, 1e-12))


def sam_deg(sr: np.ndarray, gt: np.ndarray) -> float:
    """Spectral Angle Mapper in degrees: the mean over pixels of the angle
    between the C-dim spectral vectors of sr and gt (HWC inputs). 0 = the
    spectra are parallel everywhere. Zero-signal pixels contribute 0."""
    a = sr.astype(np.float64).reshape(-1, sr.shape[-1])
    b = gt.astype(np.float64).reshape(-1, gt.shape[-1])
    num = np.sum(a * b, axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    cos = np.clip(np.divide(num, den, out=np.ones_like(num), where=den > 0), -1.0, 1.0)
    return float(np.degrees(np.mean(np.arccos(cos))))


def ergas(sr: np.ndarray, gt: np.ndarray, scale: int) -> float:
    """ERGAS (Wald 2000): 100*(h/l)*sqrt(mean_b((RMSE_b/mean_b)^2)) with
    h/l = HR/LR pixel-size ratio = 1/scale (scale=2 for the 20 m bands,
    6 for the 60 m bands). Lower is better; 0 = identical."""
    r = per_band_rmse(sr, gt)
    mu = np.mean(gt.astype(np.float64), axis=(0, 1))
    return float(100.0 / scale * np.sqrt(np.mean((r / np.maximum(np.abs(mu), 1e-12)) ** 2)))


def uiq(sr: np.ndarray, gt: np.ndarray, block: int = 8) -> float:
    """Universal Image Quality index (Wang & Bovik 2002) on non-overlapping
    block x block windows, averaged over windows and bands. 1 = identical.
    Windows where both images are constant are skipped (Q undefined there)."""
    h = gt.shape[0] // block * block
    w = gt.shape[1] // block * block
    c = gt.shape[-1]
    x = sr[:h, :w].astype(np.float64).reshape(h // block, block, w // block, block, c)
    y = gt[:h, :w].astype(np.float64).reshape(h // block, block, w // block, block, c)
    x = x.transpose(0, 2, 4, 1, 3).reshape(-1, block * block)
    y = y.transpose(0, 2, 4, 1, 3).reshape(-1, block * block)
    mx, my = x.mean(axis=1), y.mean(axis=1)
    vx, vy = x.var(axis=1, ddof=1), y.var(axis=1, ddof=1)
    cov = ((x - mx[:, None]) * (y - my[:, None])).sum(axis=1) / (block * block - 1)
    den = (vx + vy) * (mx * mx + my * my)
    ok = den > 1e-12
    if not ok.any():
        return 1.0 if np.allclose(sr[:h, :w], gt[:h, :w]) else 0.0
    q = 4.0 * cov[ok] * mx[ok] * my[ok] / den[ok]
    return float(np.mean(q))


def evaluation_table(
    sr: np.ndarray, gt: np.ndarray, baseline: np.ndarray, band_names=None,
    scale: int | None = None,
) -> str:
    """Paper-style comparison table: per-band RMSE and SRE for the network
    vs a baseline (typically bicubic), plus the global row. When `scale` is
    given, a summary row with the paper's global metrics (SAM deg, ERGAS,
    UIQ) is appended."""
    c = gt.shape[-1]
    names = list(band_names) if band_names else [f"band{i}" for i in range(c)]
    r_sr, r_bl = per_band_rmse(sr, gt), per_band_rmse(baseline, gt)
    s_sr, s_bl = per_band_sre(sr, gt), per_band_sre(baseline, gt)
    lines = [
        f"{'band':>6} | {'RMSE sr':>9} {'RMSE base':>9} | {'SRE sr':>7} {'SRE base':>8}",
        "-" * 48,
    ]
    for i in range(c):
        lines.append(
            f"{names[i]:>6} | {r_sr[i]:9.2f} {r_bl[i]:9.2f} | {s_sr[i]:7.2f} {s_bl[i]:8.2f}"
        )
    lines.append(
        f"{'ALL':>6} | {rmse(sr, gt):9.2f} {rmse(baseline, gt):9.2f} | "
        f"{sre_db(sr, gt):7.2f} {sre_db(baseline, gt):8.2f}"
    )
    if scale is not None:
        lines.append(
            f"  SAM {sam_deg(sr, gt):.3f}/{sam_deg(baseline, gt):.3f} deg | "
            f"ERGAS {ergas(sr, gt, scale):.3f}/{ergas(baseline, gt, scale):.3f} | "
            f"UIQ {uiq(sr, gt):.4f}/{uiq(baseline, gt):.4f}  (sr/baseline)"
        )
    return "\n".join(lines)
