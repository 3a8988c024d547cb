"""DataBundle: the packed, device-ready form of one (model, lead) dataset.

The port's own copy of s2s_ismr_tpu/data/bundle.py (numpy only), so the
port imports nothing of the JAX package.

The reference moves xarray DataArrays through every layer and lets Keras
see numpy at the very end (training.py:48-50). This design packs once,
early: dense float32 tensors with explicit masks and integer time
metadata, so the *entire* downstream pipeline (labeling, splits, training,
metrics) runs on the device with static shapes.

Shapes:
  x: (T, M, Y, X) hindcast ensemble (NaN = missing)
  y: (T, Y, X)    observations      (NaN = missing, e.g. ocean pixels)
  weeks/years: (T,) int32 ISO week / calendar year per sample
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .. import timeutils
from ..field import Field
from ..grid import GridSpec, make_grid


@dataclass
class DataBundle:
    x: np.ndarray            # (T, M, Y, X) float32
    y: np.ndarray            # (T, Y, X)   float32
    t: np.ndarray            # (T,) datetime64[ns]
    lats: np.ndarray         # (Y,)
    lons: np.ndarray         # (X,)
    name: str = ""

    def __post_init__(self):
        self.x = np.asarray(self.x, dtype=np.float32)
        self.y = np.asarray(self.y, dtype=np.float32)
        self.t = timeutils.to_datetime64(self.t)
        if self.x.ndim != 4 or self.y.ndim != 3:
            raise ValueError(f"x must be (T,M,Y,X), y (T,Y,X); got {self.x.shape}, {self.y.shape}")
        if self.x.shape[0] != self.y.shape[0] or self.x.shape[2:] != self.y.shape[1:]:
            raise ValueError(f"x/y misaligned: {self.x.shape} vs {self.y.shape}")
        if len(self.t) != self.x.shape[0]:
            raise ValueError("t length mismatch")

    # -- metadata --------------------------------------------------------
    @property
    def n_t(self):
        return self.x.shape[0]

    @property
    def n_m(self):
        return self.x.shape[1]

    @property
    def shape_yx(self):
        return self.x.shape[2:]

    @property
    def weeks(self):
        return timeutils.iso_week(self.t)

    @property
    def years(self):
        return timeutils.year(self.t)

    def grid(self, n_blocks_max=3, pad_lat_value=None) -> GridSpec:
        return make_grid(self.lats, self.lons, n_blocks_max, pad_lat_value)

    # -- views -------------------------------------------------------------
    def x_field(self):
        return Field(self.x, ("T", "M", "Y", "X"),
                     {"T": self.t, "Y": self.lats, "X": self.lons}, self.name)

    def y_field(self):
        return Field(self.y, ("T", "Y", "X"),
                     {"T": self.t, "Y": self.lats, "X": self.lons}, self.name)

    # -- transforms ----------------------------------------------------------
    def pad_to_grid(self, n_blocks_max=3, pad_lat_value=None) -> "DataBundle":
        """Zero-pad Y/X so the canvas divides by 2**n_blocks_max, mirroring
        the reference's manual ECMWF pad (tune_ECMWF_full.py:50-57) but for
        any grid. Pad cells are zero-filled in x and NaN in y (so labels and
        metrics mask them; the reference instead zero-fills y, relying on the
        end-of-run skill mask — we additionally NaN-guard in metrics)."""
        g = self.grid(n_blocks_max, pad_lat_value)
        if g.pad_y == 0 and g.pad_x == 0:
            return self
        py, px = g.pad_y, g.pad_x
        x = np.pad(self.x, ((0, 0), (0, 0), (0, py), (0, px)), constant_values=0.0)
        y = np.pad(self.y, ((0, 0), (0, py), (0, px)), constant_values=np.nan)
        return replace(self, x=x, y=y, lats=g.padded_lats(), lons=g.padded_lons())

    def standardize_stats(self, eps=1e-6):
        """Per-pixel (mean_T, std_T + eps) for x and y — the affine
        transform bootstrap_splits(standardize=True) applies
        (preprocessing.py:338-340). Exposed so operational realtime
        forecasts can be transformed with the HINDCAST's stats (the
        winner was trained on hindcast-standardized inputs; a realtime
        bundle's own few-sample stats would be a different transform)."""
        return (np.nanmean(self.x, 0), np.nanstd(self.x, 0) + eps,
                np.nanmean(self.y, 0), np.nanstd(self.y, 0) + eps)

    def standardize(self, eps=1e-6, stats=None) -> "DataBundle":
        """(v - mean_T) / (std_T + eps), reference preprocessing.py:338-340.
        stats: optional externally-fit standardize_stats() tuple."""
        xm, xs, ym, ys = (self.standardize_stats(eps) if stats is None
                          else stats)
        return replace(self, x=(self.x - xm) / xs, y=(self.y - ym) / ys)

    def fillna(self, value=0.0) -> "DataBundle":
        """NN-path NaN policy (preprocessing.py:341-343). The ELR path keeps
        NaNs (preprocessing.py:452-497) — per-path fidelity matters."""
        return replace(self, x=np.nan_to_num(self.x, nan=value),
                       y=np.nan_to_num(self.y, nan=value))

    def ensemble_mean(self):
        """(T, Y, X) predictor images, 'mean' mode (preprocessing.py:21-23)."""
        return np.nanmean(self.x, axis=1)

    def multi_predictor(self):
        """(T, Y, X, M) member-as-channel images, 'multi_predictor' mode
        (preprocessing.py:25-27)."""
        return np.ascontiguousarray(self.x.transpose(0, 2, 3, 1))

    def stacked(self):
        """'stacked' mode (preprocessing.py:29-35): members become extra
        batch rows. Returns a new DataBundle with T' = M*T, x of shape
        (M*T, 1, Y, X) (single pseudo-member) and y tiled M times, in the
        reference's MT=(M,T) stack order (member-major). Time metadata is
        tiled so labeling/splits see each copy at its original week/year."""
        m, t_n = self.n_m, self.n_t
        x = self.x.transpose(1, 0, 2, 3).reshape(m * t_n, 1, *self.shape_yx)
        y = np.tile(self.y, (m, 1, 1))
        t = np.tile(self.t, m)
        return replace(self, x=x, y=y, t=t)

    def predictor_images(self, mode="mean", shape_only=False):
        """Predictor tensor for the NN path, channels-last with an explicit
        channel axis — the dispatch of convert_to_ndarray
        (preprocessing.py:38-49). 'stacked' requires calling .stacked()
        first (it changes the batch axis and targets too).
        shape_only=True returns just the result shape tuple (for aval
        construction) without materializing the tensor."""
        if mode == "mean" or mode == "stacked":
            if shape_only:
                return (self.x.shape[0],) + self.x.shape[2:] + (1,)
            return self.ensemble_mean()[..., None]
        if mode == "multi_predictor":
            if shape_only:
                return ((self.x.shape[0],) + self.x.shape[2:]
                        + (self.x.shape[1],))
            return self.multi_predictor()
        raise ValueError(f"unknown predictor mode {mode!r}")

    def valid_pixels(self):
        """(Y, X) bool: pixels with no NaN anywhere in y — the reference's
        mask2 = isnan(y).any('T') (tune_ECMWF_com.py:131)."""
        return ~np.isnan(self.y).any(axis=0)


def align_midpoint_time(bundles, leads):
    """MME alignment: re-stamp each model's T to the S + mean-lead midpoint
    and assert all models share the T grid (tune_MME.py:66-81)."""
    ts = [b.t for b in bundles]
    t0 = ts[0]
    for t in ts[1:]:
        if len(t) != len(t0) or not (t == t0).all():
            raise ValueError("MME models' time axes misaligned after midpoint mapping")
    return bundles
