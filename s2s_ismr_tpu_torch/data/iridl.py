"""IRI Data Library (IRIDL) URL construction.

The port's own copy of s2s_ismr_tpu/data/iridl.py (no imports beyond the
standard library), so the port imports nothing of the JAX package.

The reference embeds ~40 giant Ingrid-expression URL templates as string
literals (dataloader.py:27-72, 348-369, 441-456). Here the same requests
are assembled from structured pieces: a source registry (dataset paths +
per-source quirks) and composable Ingrid operation fragments. The rendered
URLs are equivalent Ingrid programs hitting the same endpoints.

Key IRIDL semantics encoded below (all observed in the reference's
templates and confirmed by its data handling):
  * hindcast requests RANGE the domain, RANGEEDGES the lead window L and
    average over L (keepgrids), normalize units to mm/day, rename to prcp;
  * ECMWF reforecasts live under a hdate/S two-axis layout and need the
    hdate->T regridding program plus unit conversion from meters of water;
  * the predictand (obs) request regrids the daily obs linearly onto the
    model grid, running-averages over the lead window and SAMPLEs onto the
    model T grid — producing y aligned 1:1 with x in time;
  * optional global regrid to N degrees via X/Y GRID steps placed before
    the domain RANGE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

BASE = "https://iridl.ldeo.columbia.edu/"

# -- dataset paths (data constants, not code) -------------------------------
HINDCAST_PATHS = {
    "GEFS": "SOURCES/.Models/.SubX/.EMC/.GEFSv12_CPC/.hindcast/.weekly/.pr",
    "IITM1": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsasfer/.hindcast/.APCPsfc",
    "IITM2": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsasfer_sc/.hindcast/.APCPsfc",
    "IITM3": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsaszc/.hindcast/.APCPsfc",
    "IITM4": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsaszc_sc/.hindcast/.APCPsfc",
    "IITM5": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.sasfer/.hindcast/.APCPsfc",
    "IITM6": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.saszc/.hindcast/.APCPsfc",
    "ECMWF_perturbed":
        "home/.jingyuan/.ECMWF/.S2S/.ECMF/.reforecast/.perturbed/.sfc_precip/.tp",
    "ECMWF_control":
        "home/.jingyuan/.ECMWF/.S2S/.ECMF/.reforecast/.control/.sfc_precip/.tp",
}

FORECAST_PATHS = {
    "GEFS": "SOURCES/.Models/.SubC/.EMC/.GEFSv12_CPC/.forecast/.pr",
    "IITM1": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsasfer/.forecast/.APCPsfc",
    "IITM2": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsasfer_sc/.forecast/.APCPsfc",
    "IITM3": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsaszc/.forecast/.APCPsfc",
    "IITM4": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.nsaszc_sc/.forecast/.APCPsfc",
    "IITM5": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.sasfer/.forecast/.APCPsfc",
    "IITM6": "SOURCES/.IITM/.ERPv2/.r0p5/.CFS/.saszc/.forecast/.APCPsfc",
    # realtime ECMWF cycles (CY48 from 2023-06-27 onward, dataloader.py:373-379)
    "ECMWF_CY41-47":
        "SOURCES/.ECMWF/.S2S/.ECMF/.CY41-47/.forecast/.perturbed/.sfc_precip/.tp",
    "ECMWF_CY48":
        "SOURCES/.ECMWF/.S2S/.ECMF/.CY48/.forecast/.perturbed/.sfc_precip/.tp",
}

OBS_PATHS = {
    "IMD": "SOURCES/.IMD/.RF0p25/.gridded/.daily/.v1989-2022/.rf",
    "GPCP": "SOURCES/.NASA/.GPCP/.V1DD/.V1p3/.precip",
    "CHIRPS": "SOURCES/.UCSB/.CHIRPS/.v2p0/.daily-improved/.global/.0p25/.prcp",
    "CPC": ("SOURCES/.NOAA/.NCEP/.CPC/.temperature/.daily/.tmin/"
            "SOURCES/.NOAA/.NCEP/.CPC/.temperature/.daily/.tmax/add/2/div"),
}

# climate-index series for the MJO/ENSO diagnostics of the reference's
# missing Realtime_fcast_MME.ipynb (README.md:22): the BOM realtime
# multivariate MJO index (Wheeler & Hendon 2004 RMM1/RMM2, daily) and
# Nino3.4 SST anomalies (Kaplan extended, monthly), both hosted by IRIDL
INDEX_PATHS = {
    "RMM1": "SOURCES/.BoM/.MJO/.RMM/.RMM1",
    "RMM2": "SOURCES/.BoM/.MJO/.RMM/.RMM2",
    "NINO34": "SOURCES/.Indices/.nino/.EXTENDED/.NINO34",
}

IITM_MEMBERS = ["IITM1", "IITM2", "IITM3", "IITM4", "IITM5", "IITM6"]
ECMWF_STREAMS = ["ECMWF_perturbed", "ECMWF_control"]
SUPPORTED_MODELS = ["GEFS", "IITM", "ECMWF"] + IITM_MEMBERS + ECMWF_STREAMS
SUPPORTED_OBS = list(OBS_PATHS)


# -- Ingrid operation fragments --------------------------------------------
def regrid_global(step) -> str:
    """Linear regrid of the whole globe to `step` degrees."""
    return f"X/-180/{step}/179/GRID/Y/-90/{step}/90/GRID/"


def domain_range(west, east, south, north) -> str:
    return f"Y/{south}/{north}/RANGE/X/{west}/{east}/RANGE/"


def lead_average(lead_start, lead_end) -> str:
    """Average the accumulation over the lead-day window, keep grids."""
    return (f"L/{lead_start}/{lead_end}/RANGEEDGES/%5B/L%5D//keepgrids/"
            "average//units/(mm/day)/def//name/(prcp)/def")


def s_window(first_year, final_year, season, weekly=False) -> str:
    """Select forecast starts: year range + 7-day stride + season window."""
    if weekly:   # GEFS layout: explicit date range + 7-day STEP
        return (f"S/(0000%202%20Jan%20{first_year})/"
                f"(0000%201%20Dec%20{final_year})/RANGEEDGES/S/7/STEP/"
                f"S/({season})/VALUES/")
    return (f"S/%28{first_year}-{final_year}%29VALUES/"
            f"S/({season})/VALUES/")


def ecmwf_lead_select(lead_start, lead_end) -> str:
    """ECMWF lead-endpoint selection (cumulative precip; the differencing
    happens after start selection, ecmwf_diff_convert)."""
    return f"L/{lead_start}/{lead_end}/VALUES/"


def ecmwf_diff_convert() -> str:
    """Difference the cumulative-precip lead endpoints and convert meters
    of water to mm (reference template body, dataloader.py:35-36)."""
    return ("%5BL%5Ddifferences/"
            "c%3A//name//water_density/def/998/(kg/m3)/%3Ac/div/"
            "/mm/unitconvert//name/(prcp)/def/-999/setmissing_value/")


def ecmwf_hdate_range(first_year, final_year) -> str:
    return f"hdate/({first_year})/({final_year})/RANGE"


# the S/L->T Ingrid programs (opaque but load-bearing time gridders)
T_GRIDDER = ("/L/S/add/0/RECHUNK//name//T/def/2/"
             "%7Bexch%5BL/S%5D//I/nchunk/NewIntegerGRID/"
             "replaceGRIDstream%7Drepeat/use_as_grid/")
T_GRIDDER_ECMWF = ("/hdate//pointwidth/0/def/-6/shiftGRID/"
                   "hdate/(days%20since%201960-01-01)/streamgridunitconvert/"
                   "S/(days%20since%20{fcast_year}-01-01)/"
                   "streamgridunitconvert/S//units//days/def/"
                   "L/hdate/add/add/0/RECHUNK/L/removeGRID//name//T/def/2/"
                   "%7Bexch%5BS/hdate%5D//I/nchunk/NewIntegerGRID/"
                   "replaceGRIDstream%7Drepeat/use_as_grid/")


@dataclass(frozen=True)
class Request:
    """A fully-specified IRIDL fetch."""
    url: str
    cache_name: str


def gefs_climatology_url(domain) -> str:
    """GEFS lead-dependent model climatology (dc0018) subset to the
    domain — the external-climatology ACC path (ACCs.ipynb cell 28)."""
    west, east, south, north = domain
    return (f"{BASE}SOURCES/.Models/.SubX/.EMC/.GEFSv12_CPC/.hindcast/"
            f".dc0018/.pr/Y/{south}/{north}/RANGE/X/{west}/{east}/RANGE/"
            f"data.nc")


def index_url(key, years=None) -> str:
    """Climate-index series request (RMM1/RMM2/NINO34). years optionally
    RANGEs T to keep the file small; omitted = full record."""
    if key not in INDEX_PATHS:
        raise ValueError(f"unknown index {key!r}; "
                         f"supported: {sorted(INDEX_PATHS)}")
    sel = f"T/({years[0]})/({years[1]})/RANGE/" if years else ""
    return BASE + INDEX_PATHS[key] + "/" + sel + "data.nc"


def hindcast_url(model, years, lead, season, domain, regrid=None,
                 fcast_year=2023) -> str:
    """Predictor (hindcast) request for one source key."""
    if model not in HINDCAST_PATHS:
        raise ValueError(f"unknown hindcast source {model!r}; "
                         f"supported: {sorted(HINDCAST_PATHS)}")
    west, east, south, north = domain
    path = HINDCAST_PATHS[model]
    rg = regrid_global(regrid) if regrid else ""
    if model.startswith("ECMWF"):
        # reference order (dataloader.py:35-36): lead VALUES -> S/7/STEP
        # weekly subsample -> season S VALUES -> [L]differences+convert ->
        # hdate RANGE. ECMWF S2S starts are twice-weekly; omitting the
        # 7-day STEP silently doubles the reforecast sample
        expr = (path + "/" + rg + domain_range(west, east, south, north)
                + ecmwf_lead_select(*lead)
                + "S/7/STEP/"
                + f"S/({season}%20{fcast_year})/VALUES/"
                + ecmwf_diff_convert()
                + ecmwf_hdate_range(*years)
                + T_GRIDDER_ECMWF.format(fcast_year=fcast_year)
                + "L/removeGRID/")
    else:
        weekly = model == "GEFS"
        expr = (path + "/" + rg
                + s_window(years[0], years[1], season, weekly=weekly)
                + domain_range(west, east, south, north)
                + lead_average(*lead) + "/L/removeGRID/")
    return BASE + expr + "data.nc"


def predictand_url(model, obs, years, lead, season, domain,
                   regrid=None, fcast_year=2023) -> str:
    """Observation request regridded to the model grid and SAMPLEd onto its
    T axis (the y aligned with x)."""
    if obs not in OBS_PATHS:
        raise ValueError(f"unknown obs {obs!r}; supported: {SUPPORTED_OBS}")
    west, east, south, north = domain
    path = HINDCAST_PATHS[model]
    rg = regrid_global(regrid) if regrid else ""
    if model.startswith("ECMWF"):
        model_part = (path + "/" + rg + domain_range(west, east, south, north)
                      + ecmwf_lead_select(*lead)
                      + "S/7/STEP/"
                      + f"S/({season}%20{fcast_year})/VALUES/"
                      + ecmwf_diff_convert()
                      + ecmwf_hdate_range(*years)
                      + T_GRIDDER_ECMWF.format(fcast_year=fcast_year))
    else:
        weekly = model == "GEFS"
        model_part = (path + "/" + rg
                      + s_window(years[0], years[1], season, weekly=weekly)
                      + domain_range(west, east, south, north)
                      + lead_average(*lead) + T_GRIDDER)
    obs_part = (OBS_PATHS[obs] + "/"
                + domain_range(west, east, south, north).rstrip("/"))
    return (BASE + model_part + obs_part
            + "/%5BX/Y%5D/regridLinear/"
            "T/(days%20since%201960-01-01)/streamgridunitconvert/"
            f"T/{lead[1]}/{lead[0]}/sub/runningAverage/"
            "T/2/index/.T/SAMPLE/nip//name/(prcp)/def/data.nc")


def forecast_url(model, day, month_name, year, lead, domain,
                 regrid=None) -> str:
    """Realtime forecast request (dataloader.py:338-430 capability)."""
    west, east, south, north = domain
    key = model
    if model == "ECMWF":
        from ..timeutils import MONTHS
        m = MONTHS[month_name]
        # cycle cutover is a DATE (2023-06-27); the reference compares
        # month/day only because it was written for 2023
        # (dataloader.py:373-379) — honoring the year keeps any other
        # operational year from selecting the wrong cycle dataset
        key = ("ECMWF_CY41-47" if (year, m, day) < (2023, 6, 27)
               else "ECMWF_CY48")
    if key not in FORECAST_PATHS:
        raise ValueError(f"unknown forecast source {model!r}")
    path = FORECAST_PATHS[key]
    rg = regrid_global(regrid) if regrid else ""
    sel = f"S/(0000%20{day}%20{month_name}%20{year})/VALUES/"
    dom = domain_range(west, east, south, north)
    if model == "ECMWF":
        # realtime templates keep differences+convert inline (no S/7/STEP:
        # a single start is selected), dataloader.py:356-357
        body = (path + "/" + rg + sel + dom
                + ecmwf_lead_select(*lead) + ecmwf_diff_convert()
                + "%5BL%5D/average")
    else:
        scale = "/86400/mul" if key == "GEFS" else ""
        body = (path + "/" + rg + sel + dom
                + f"L/{lead[0]}/{lead[1]}/RANGEEDGES/%5B/L%5D/average/"
                "/units/(mm/day)/def//name/(prcp)/def" + scale)
    return BASE + body + "/data.nc"


def obs_url(model, obs, week_lead, domain, regrid=None) -> str:
    """Realtime observation request regridded to the model grid
    (dataloader.py:433-495 capability)."""
    west, east, south, north = domain
    path = HINDCAST_PATHS["ECMWF_perturbed" if model == "ECMWF"
                          else ("IITM1" if model == "IITM" else model)]
    rg = regrid_global(regrid) if regrid else ""
    model_part = path + "/" + rg + domain_range(west, east, south, north)
    obs_part = OBS_PATHS[obs] + "/" + domain_range(west, east, south, north)
    lead_start, lead_end = week_lead
    return (BASE + model_part + obs_part.rstrip("/")
            + "/%5BX/Y%5DregridLinear/"
            "T/(days%20since%201960-01-01)/streamgridunitconvert/"
            f"T/{lead_end}/{lead_start}/sub/runningAverage/"
            "/name/(prcp)/def/data.nc")
