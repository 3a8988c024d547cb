"""Declarative configs, one per reference tune_*.py script (port of
s2s_ismr_tpu/pipelines/configs.py, field for field).

Every knob mirrors the constants hardcoded at the top of the corresponding
script's main() (e.g. tune_ECMWF_com.py:24-41, tuning grid :91-92). The
only change from the JAX module is where TuningGrid comes from: the JAX
one imports jax through its sweep module.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

from ..grid import Domain
from ..train.sweep import TuningGrid

# lead-day windows per named week (dataloader.py:169)
LEAD_MAPPING = {"wk1": (2, 8), "wk2": (9, 15), "wk3-4": (16, 29)}


@dataclass(frozen=True)
class PipelineConfig:
    name: str
    models: Tuple[str, ...]                  # 1 entry = single-model script
    obs: str = "IMD"
    domain: Domain = Domain(67, 98, 7, 38)
    season: str = "May-Sep"
    years: Tuple[int, int] = (2003, 2018)
    week: str = "wk3-4"
    custom_lead: Optional[Tuple[int, int]] = None
    custom_leads: Optional[Dict[str, Tuple[int, int]]] = None   # MME only
    regrid: Optional[float] = None           # degrees, None = native grid
    n_bootstraps: int = 10
    out_dir: str = ""                        # 'Common Period/' etc.
    # results-tree model name: outputs/{out_dir}/{output_name}_{obs}/.
    # Single-model configs default to the model name; MME configs MUST
    # name it explicitly — the reference writes blends under MME_IMD /
    # 2MME_IMD (tune_MME.py:47,92-93,135-137; tune_2MME.py:47,80-81),
    # which is the filesystem contract Bar_plot.ipynb cell 5 reads
    # ("MME_IMD"/"2MME_IMD" in its models list). Model *checkpoints*
    # stay per-member under models/{out_dir}/{member}_{obs} exactly as
    # the reference keeps per-member Keras files (tune_MME.py:43).
    output_name: Optional[str] = None
    pad_y_rows: int = 0                      # ECMWF full: 1
    pad_lat_value: Optional[float] = None    # ECMWF full: 40.5
    # native-grid point counts (n_lat, n_lon) for the synthetic source;
    # regrid=None configs otherwise have no step to derive a grid from
    # (ECMWF full 23x24 pre-pad, IITM full 64x64, GEFS full 32x32)
    synthetic_grid: Optional[Tuple[int, int]] = None
    tuning: TuningGrid = field(default_factory=TuningGrid)
    architecture: str = "unet"           # 'unet' | 'cnn' | 'mlp'
    predictor: str = "mean"              # 'mean' | 'multi_predictor' | 'stacked'
    # U-Net head (deep_nn_models.py:102-105): 'proba' trains softmax
    # tercile probabilities on CE; 'deterministic' trains a ReLU precip
    # head on NaN-masked MSE, and its predictions are scored by
    # categorizing them with the fold's tercile edges (the reference
    # leaves this head untrainable — its compile hardcodes CE)
    output: str = "proba"                # 'proba' | 'deterministic'
    epochs: int = 100
    elr_frac_test: float = 0.3
    nn_frac_valid: float = 0.2
    nn_frac_test: float = 0.1
    # per-pixel (v - mean_T)/(std_T + 1e-6) of x and y before splitting —
    # the bootstrap_splits(..., standardize=) option (preprocessing.py:
    # 335-343, 452-456); the reference scripts leave it False
    standardize: bool = False

    @property
    def is_mme(self):
        return len(self.models) > 1

    @property
    def result_name(self):
        """Name of the outputs/figures subtree: {result_name}_{obs}."""
        return self.output_name or "_".join(self.models)

    def lead(self, model=None):
        if self.custom_leads and model:
            return self.custom_leads[model]
        return self.custom_lead or LEAD_MAPPING[self.week]

    def with_week(self, week):
        """Re-target the config at another lead week.

        The reference's documented usage is editing the script constant
        and re-running (tune_ECMWF_com.py:31 `week = "wk3-4"  #wk1, wk2
        or wk3-4`) — that is how its Bar_plot matrix rows for wk1/wk2
        get produced. Overriding the week here reverts custom_lead /
        custom_leads to the standard LEAD_MAPPING: in the reference a
        hardcoded custom_lead silently WINS over an edited week
        (dataloader.py:170-173) while the output filenames carry the new
        week's name — we implement the intended contract (leads that
        match the week), not the footgun. A same-week call is a no-op,
        preserving the config's own custom leads."""
        if week not in LEAD_MAPPING:
            raise KeyError(f"week must be one of {sorted(LEAD_MAPPING)}, "
                           f"got {week!r}")
        if week == self.week:
            return self
        return replace(self, week=week, custom_lead=None, custom_leads=None)

    def fast_variant(self, n_bootstraps=2, epochs=6):
        """Shrunken config for smoke runs/CI: fewer folds/epochs, a 2-trial
        grid. Not part of reference parity — a framework affordance.
        synthetic_grid is kept: native-grid configs need it to stay
        divisible (an explicit --step still overrides it)."""
        g = self.tuning
        small = TuningGrid(n_blocks=(min(g.n_blocks),),
                           n_filters=(min(g.n_filters),),
                           ct_kernels=tuple(g.ct_kernels[:2]),
                           batch_sizes=(g.batch_sizes[0],),
                           learning_rates=(g.learning_rates[0],),
                           patience=min(g.patience, 5))
        return replace(self, n_bootstraps=n_bootstraps, epochs=epochs,
                       tuning=small)


_COM_GRID = TuningGrid(n_blocks=(3,), n_filters=(2, 3),
                       ct_kernels=((2, 2), (3, 3), (5, 5)),
                       batch_sizes=(16, 32), learning_rates=(1e-3, 1e-4),
                       patience=15)
_BLOCKS_GRID = TuningGrid(n_blocks=(3, 4, 5), n_filters=(2, 3),
                          ct_kernels=((2, 2), (3, 3), (5, 5)),
                          batch_sizes=(16,), learning_rates=(1e-3,),
                          patience=10)

CONFIGS: Dict[str, PipelineConfig] = {
    # tune_ECMWF_com.py: 1-deg regrid -> 32x32, custom lead (16,30)
    "tune_ECMWF_com": PipelineConfig(
        name="tune_ECMWF_com", models=("ECMWF",), years=(2003, 2018),
        custom_lead=(16, 30), regrid=1, out_dir="Common Period/",
        tuning=_COM_GRID),
    # tune_ECMWF_full.py: native grid 23x24 padded to 24x24 (lat 40.5)
    "tune_ECMWF_full": PipelineConfig(
        name="tune_ECMWF_full", models=("ECMWF",),
        domain=Domain(66, 100, 7, 39), years=(2003, 2022),
        custom_lead=(17, 30), regrid=None, out_dir="Full Period/",
        pad_y_rows=1, pad_lat_value=40.5, synthetic_grid=(23, 24),
        tuning=_COM_GRID),
    # tune_GEFS_com.py: wk2 lead, blocks-sweep grid
    "tune_GEFS_com": PipelineConfig(
        name="tune_GEFS_com", models=("GEFS",), years=(2003, 2018),
        week="wk2", regrid=1, out_dir="Common Period/", tuning=_BLOCKS_GRID),
    # tune_GEFS_full.py: 1989-2018 native grid
    "tune_GEFS_full": PipelineConfig(
        name="tune_GEFS_full", models=("GEFS",), years=(1989, 2018),
        regrid=None, out_dir="Full Period/", synthetic_grid=(32, 32),
        tuning=_BLOCKS_GRID),
    # tune_IITM_com.py
    "tune_IITM_com": PipelineConfig(
        name="tune_IITM_com", models=("IITM",), years=(2003, 2018),
        regrid=1, out_dir="Common Period/", tuning=_BLOCKS_GRID),
    # tune_IITM_full.py: native 0.5 deg -> 64x64
    "tune_IITM_full": PipelineConfig(
        name="tune_IITM_full", models=("IITM",),
        domain=Domain(67, 98.5, 7, 38.5), years=(2003, 2022),
        regrid=None, out_dir="Full Period/", synthetic_grid=(64, 64),
        tuning=_BLOCKS_GRID),
    # tune_MME.py: 3-model blend with per-model leads (tune_MME.py:49)
    "tune_MME": PipelineConfig(
        name="tune_MME", models=("GEFS", "IITM", "ECMWF"), years=(2003, 2018),
        custom_leads={"GEFS": (16, 29), "IITM": (16, 29), "ECMWF": (16, 30)},
        regrid=1, out_dir="MME/", output_name="MME", tuning=_BLOCKS_GRID),
    # tune_2MME.py: IITM+ECMWF only
    "tune_2MME": PipelineConfig(
        name="tune_2MME", models=("IITM", "ECMWF"), years=(2003, 2018),
        custom_leads={"IITM": (16, 29), "ECMWF": (16, 30)},
        regrid=1, out_dir="2MME/", output_name="2MME", tuning=_BLOCKS_GRID),
}


def get_config(name: str) -> PipelineConfig:
    key = name if name in CONFIGS else f"tune_{name}"
    if key not in CONFIGS:
        raise KeyError(f"unknown pipeline {name!r}; available: "
                       f"{sorted(CONFIGS)}")
    return CONFIGS[key]
