"""The benchmark's inputs, all made from `--seed` by this file alone.

One general generator reads a configuration file (the deployment: grid,
years, season, lead, folds, the trial bucket) and makes what a tuning
sweep of it is handed:

  * a synthetic hindcast: the forecast images x and the observed rainfall
    y, ocean pixels 0 (the pipeline's fillna(0)); the recipe of the port's
    data/synthetic.py (a smoothed truth field, a forecast correlated with
    it at `signal`, member noise), rewritten in torch on the run's device.
    The configuration's `data.predictor` (PREDICTORS) says how the members
    reach the model, as the reference's convert_to_ndarray does:
    'mean' (the default) hands the ensemble mean, x (T, H, W, 1) and y
    (T, H, W); 'stacked' hands each member as a row of its own, in the
    member-major order MT = (M, T) of the port's DataBundle.stacked(),
    x (M T, H, W, 1), with y, the years, the weeks and so the fold masks
    tiled M times;
  * the bootstrap fold masks over the years (RandomState(i) per fold, as
    the reference's preprocessing.py seeds them; the same for every seed,
    so every seed runs the same batch counts);
  * each fold's rolling ISO-week tercile labels, fit on the fold's train
    rows and one-hot (F, T, H, W, 3), unlabelled pixels all zero; stacked,
    fit on the tiled rows (the reference's preprocess_stacked), which is
    not the mean mode's labels tiled: a linear quantile over a record
    repeated M times differs from one over the record;
  * each lane's initial weights (Keras glorot-uniform kernels, zero
    biases, BatchNorm at 1 / 0 / 0 / 1), drawn on the device in one call,
    and its batch orders (epochs, T), drawn on the host as the sweep's own
    torch.randperm would be.

It imports nothing of the program, so the program and the reference get
the same inputs from a third party. Weights and orders are keyed by (seed,
call, fold, trial): every sweep call of a run trains lanes of its own.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

N_ISO_WEEKS = 53
PREDICTORS = ("mean", "stacked")
_MONTHS = {"Jan": 1, "Feb": 2, "Mar": 3, "Apr": 4, "May": 5, "Jun": 6,
           "Jul": 7, "Aug": 8, "Sep": 9, "Oct": 10, "Nov": 11, "Dec": 12}


def derive_seed(*parts) -> int:
    """A 63-bit seed from any whole numbers (the run's seed may exceed 32
    bits, or be negative)."""
    words = [int(p) % (1 << 64) for p in parts]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def predictor(cfg):
    """The configuration's predictor mode, 'mean' where it names none."""
    mode = cfg["data"].get("predictor", "mean")
    if mode not in PREDICTORS:
        raise ValueError(f"data.predictor {mode!r} is not one of "
                         f"{', '.join(PREDICTORS)}")
    return mode


def sample_dates(years, season, lead_days):
    """Target dates T = weekly Monday inits over `season` of each year in
    the closed range `years`, plus the lead window's mean (rounded as
    Python rounds), and each one's year and ISO week."""
    a, b = season.split("-")
    months = set(range(_MONTHS[a], _MONTHS[b] + 1))
    shift = datetime.timedelta(days=round((lead_days[0] + lead_days[1]) / 2))
    out = []
    for yr in range(years[0], years[1] + 1):
        d = datetime.date(yr, 1, 1)
        d += datetime.timedelta(days=(7 - d.weekday()) % 7)
        while d.year == yr:
            if d.month in months:
                out.append(d + shift)
            d += datetime.timedelta(days=7)
    sample_years = np.array([d.year for d in out])
    weeks = np.array([d.isocalendar()[1] for d in out])
    return sample_years, weeks


def _smooth(a, k):
    """Box mean over the last two axes, k x k, edges repeated."""
    lead = a.shape[:-2]
    b = a.reshape((-1, 1) + a.shape[-2:])
    b = F.avg_pool2d(F.pad(b, (k // 2,) * 4, mode="replicate"), k, stride=1)
    return b.reshape(lead + b.shape[-2:])


def hindcast(cfg, seed, device):
    """(x (T, H, W, 1), y (T, H, W)) float32 on `device`; stacked, (x (M T,
    H, W, 1), y (M T, H, W)), row m T + t member m at time t."""
    d = cfg["data"]
    ny, nx = cfg["grid"]
    _, weeks = sample_dates(cfg["years"], d["season"], d["lead_days"])
    nt, m, sig = len(weeks), d["members"], d["signal"]
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, 0))

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    w = torch.as_tensor(weeks, dtype=torch.float32, device=device)
    seasonal = (3.0 + 2.5 * torch.sin((w - 18) / 22 * math.pi))[:, None, None]
    # gamma(2, 1) as the sum of two unit exponentials
    topo = _smooth(-torch.log(uniform(2, ny, nx).clamp_min(1e-12)).sum(0), 5)
    truth = _smooth(normal(nt, ny, nx), 5)
    y = seasonal * topo * torch.exp(0.5 * truth)
    blob = _smooth(normal(ny, nx), 7)
    ocean = blob < torch.quantile(blob.reshape(-1), d["ocean_frac"])
    y = torch.where(ocean, torch.zeros_like(y), y)
    fc = sig * truth + math.sqrt(1 - sig ** 2) * _smooth(normal(nt, ny, nx), 5)
    noise = _smooth(0.7 * normal(m, nt, ny, nx), 3)
    bias = 0.8 + 0.4 * uniform(1)
    members = bias * seasonal * topo * torch.exp(0.5 * (fc + noise))
    if predictor(cfg) == "stacked":
        return members.reshape(m * nt, ny, nx, 1), y.repeat(m, 1, 1)
    return members.mean(0)[..., None].contiguous(), y


def fold_masks(sample_years, folds, frac_valid, frac_test):
    """(train (F, T), val (F, T)) bool: fold i permutes the unique years with
    RandomState(i); the first int(frac_valid n) are val, the next
    int(frac_test n) test, the rest train (the reference's NN split)."""
    uniq = np.unique(sample_years)
    n_val, n_test = int(frac_valid * len(uniq)), int(frac_test * len(uniq))
    train, val = [], []
    for i in range(folds):
        perm = np.random.RandomState(i).permutation(uniq)
        val.append(np.isin(sample_years, perm[:n_val]))
        train.append(np.isin(sample_years, perm[n_val + n_test:]))
    return np.stack(train), np.stack(val)


def tercile_onehot(y, weeks, pool, window=1):
    """(T, H, W, 3) one-hot rolling-tercile labels of y (T, H, W): a sample
    of ISO week w is compared with the [1/3, 2/3] quantiles (linear) over
    the pool's samples whose week lies within `window` of w (wrapping at
    53): below the first is class 0, above the second class 2, else 1.
    A week with no pooled sample is left unlabelled (all zero)."""
    flat = y.reshape(y.shape[0], -1)
    out = torch.zeros(flat.shape + (3,), device=y.device)
    qs = torch.tensor([1 / 3, 2 / 3], device=y.device)
    pool = torch.as_tensor(pool, device=y.device)
    wk = torch.as_tensor(weeks, device=y.device)
    for w in np.unique(weeks):
        near = [((w + i - 1) % N_ISO_WEEKS) + 1
                for i in range(-window, window + 1)]
        rows = pool & torch.isin(wk, torch.as_tensor(near, device=y.device))
        if not bool(rows.any()):
            continue
        q0, q1 = torch.quantile(flat[rows], qs, dim=0)
        sel = wk == int(w)
        v = flat[sel]
        cls = torch.where(v < q0, 0, torch.where(v > q1, 2, 1))
        out[sel] = F.one_hot(cls, 3).to(torch.float32)
    return out.reshape(y.shape + (3,))


@dataclass
class Trial:
    """One trial of the bucket, in the reference's product order
    (batch size, learning rate, ct kernel, filters, n_blocks)."""
    index: int
    batch_size: int
    lr: float
    ct_kernel: tuple
    filters: int
    n_blocks: int


def bucket_trials(cfg):
    b = cfg["bucket"]
    out = []
    for bs in b["batch_sizes"]:
        for lr in b["learning_rates"]:
            for ct in b["ct_kernels"]:
                for fl in b["n_filters"]:
                    for nb in b["n_blocks"]:
                        out.append(Trial(len(out), bs, lr, tuple(ct), fl, nb))
    return out


@dataclass
class Inputs:
    x: torch.Tensor              # (T, H, W, 1); stacked T is M x the dates
    y_onehot: torch.Tensor       # (F, T, H, W, 3)
    train: np.ndarray            # (F, T) bool
    val: np.ndarray              # (F, T) bool
    trials: list
    seed: int
    predictor: str               # one of PREDICTORS


def make_inputs(cfg, seed, device) -> Inputs:
    d = cfg["data"]
    mode = predictor(cfg)
    sample_years, weeks = sample_dates(cfg["years"], d["season"],
                                       d["lead_days"])
    if mode == "stacked":
        sample_years = np.tile(sample_years, d["members"])
        weeks = np.tile(weeks, d["members"])
    x, y = hindcast(cfg, seed, device)
    train, val = fold_masks(sample_years, cfg["folds"], d["frac_valid"],
                            d["frac_test"])
    y_oh = torch.stack([tercile_onehot(y, weeks, train[f])
                        for f in range(cfg["folds"])])
    return Inputs(x, y_oh, train, val, bucket_trials(cfg), seed, mode)


def lane_init(spec, seed, call, fold, trial, device):
    """A lane's initial state_dict from `spec` [(name, shape, init)], init
    one of 'glorot' (U(-l, l), l = sqrt(6 / (fan_in + fan_out)), fans over
    the receptive field of the stored (kh, kw, in, out) kernel), 'zeros',
    'ones'; the glorot draws in one call on `device`."""
    g = torch.Generator(device=device).manual_seed(
        derive_seed(seed, 1, call, fold, trial))
    sizes = [math.prod(s) for _, s, init in spec if init == "glorot"]
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out, off = {}, 0
    for name, shape, init in spec:
        if init == "glorot":
            rf = math.prod(shape[:-2])
            limit = math.sqrt(6.0 / (rf * shape[-2] + rf * shape[-1]))
            n = math.prod(shape)
            out[name] = (u[off:off + n] * limit).view(shape)
            off += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def lane_orders(seed, call, fold, trial, epochs, T):
    """A lane's batch orders: (epochs, T) int64 permutations on the host."""
    g = torch.Generator().manual_seed(derive_seed(seed, 2, call, fold, trial))
    return torch.argsort(torch.rand((epochs, T), generator=g), dim=1)
