"""Bootstrap cross-validation splits as *masks*, not ragged arrays.

The port's own copy of s2s_ismr_tpu/train/splits.py (numpy only), so the
port imports nothing of the JAX package.

The reference shuffles unique years with ``np.random.seed(i)`` per
bootstrap and slices year lists into val/test/train
(preprocessing.py:335-391 NN path; :452-497 ELR path; :500-638 MME
variants share the same permutation because the seed is the fold index).

Instead of materializing per-fold ragged subsets, every fold is a
boolean mask over the FULL time axis. Data tensors stay (T, ...) and
identical across folds; only the masks (n_folds, T) differ. Ragged-ness
disappears; the whole fold axis batches.

Seed parity is exact: the same numpy calls in the same order reproduce
the reference's year partitions bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FoldMasks:
    """Boolean (n_folds, T) membership masks + the year lists behind them."""
    train: np.ndarray
    val: np.ndarray | None
    test: np.ndarray
    train_years: list
    val_years: list | None
    test_years: list

    @property
    def n_folds(self):
        return self.train.shape[0]


def _year_partitions(unique_years, n_bootstraps, frac_valid, frac_test):
    """NN-path partitions (preprocessing.py:359-371): seed=i, permute years,
    valid = first n_valid, test = next n_test, train = rest.

    RandomState(i) is bit-identical to the reference's global
    np.random.seed(i) + np.random.permutation (the legacy global RNG IS a
    RandomState), without touching process-global state — the suite
    runner computes splits on a background prefetch thread concurrently
    with the foreground pipeline, and a global seed() would race."""
    tr, va, te = [], [], []
    for i in range(n_bootstraps):
        shuffled = np.random.RandomState(i).permutation(unique_years)
        n_years = len(shuffled)
        n_valid = int(frac_valid * n_years)
        n_test = int(frac_test * n_years)
        if (frac_valid > 0 and n_valid == 0) or (frac_test > 0 and n_test == 0):
            # the reference silently produces an empty split here, which
            # surfaces much later as all-NaN RPSS; fail at the source
            raise ValueError(
                f"{n_years} unique years with frac_valid={frac_valid}, "
                f"frac_test={frac_test} gives an empty val/test split")
        va.append(shuffled[:n_valid])
        te.append(shuffled[n_valid:n_valid + n_test])
        tr.append(shuffled[n_valid + n_test:])
    return tr, va, te


def _year_partitions_elr(unique_years, n_bootstraps, frac_test):
    """ELR-path partitions (preprocessing.py:471-481): seed=i, permute,
    train = all but last n_test, test = last n_test."""
    tr, te = [], []
    for i in range(n_bootstraps):
        # thread-safe bit-identical reference partitions (see above)
        shuffled = np.random.RandomState(i).permutation(unique_years)
        n_test = int(len(shuffled) * frac_test)
        if n_test == 0:
            # the reference's shuffled[:-0] would silently yield an EMPTY
            # train set here (numpy slicing trap); fail loudly instead
            raise ValueError(
                f"frac_test={frac_test} with {len(shuffled)} unique years "
                "gives an empty test split; need more years")
        tr.append(shuffled[:-n_test])
        te.append(shuffled[-n_test:])
    return tr, te


def _masks(sample_years, year_lists):
    return np.stack([np.isin(sample_years, yl) for yl in year_lists])


def bootstrap_masks(sample_years, n_bootstraps=10, frac_valid=0.2,
                    frac_test=0.1) -> FoldMasks:
    """NN-path CV masks. sample_years: (T,) int array of per-sample years."""
    uniq = np.unique(np.asarray(sample_years))
    tr, va, te = _year_partitions(uniq, n_bootstraps, frac_valid, frac_test)
    return FoldMasks(train=_masks(sample_years, tr),
                     val=_masks(sample_years, va),
                     test=_masks(sample_years, te),
                     train_years=[set(a.tolist()) for a in tr],
                     val_years=[set(a.tolist()) for a in va],
                     test_years=[set(a.tolist()) for a in te])


def bootstrap_masks_elr(sample_years, n_bootstraps=10, frac_test=0.3) -> FoldMasks:
    """ELR-path 2-way masks (reference calls its test set 'val' when passed
    to train_elr in the tune scripts, tune_ECMWF_com.py:56-58)."""
    uniq = np.unique(np.asarray(sample_years))
    tr, te = _year_partitions_elr(uniq, n_bootstraps, frac_test)
    return FoldMasks(train=_masks(sample_years, tr), val=None,
                     test=_masks(sample_years, te),
                     train_years=[set(a.tolist()) for a in tr], val_years=None,
                     test_years=[set(a.tolist()) for a in te])
