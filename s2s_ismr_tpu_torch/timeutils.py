"""ISO-calendar time machinery.

The port's own copy of s2s_ismr_tpu/timeutils.py, so the port imports
nothing of the JAX package. pandas is imported inside the calls that use
it, so importing the port needs no pandas.

The reference keys its climatological tercile edges on ISO calendar weeks
(1..53) extracted from the 'T' coordinate with pandas
(the reference's utils/preprocessing.py:104,133) and wraps rolling week
windows with ``(week + i) % 53 or 53`` (preprocessing.py:114).

Calendar math stays on the host (it is data preparation, not compute);
the resulting integer week/year vectors ride into the device bundle.
"""

from __future__ import annotations

import numpy as np

N_ISO_WEEKS = 53


def to_datetime64(t):
    """Coerce arbitrary date-like vectors to numpy datetime64[ns]."""
    import pandas as pd
    return pd.to_datetime(np.asarray(t)).values


def iso_week(t):
    """ISO calendar week number (1..53) per timestamp."""
    import pandas as pd
    idx = pd.DatetimeIndex(to_datetime64(t))
    return idx.isocalendar().week.to_numpy().astype(np.int32)


def year(t):
    import pandas as pd
    idx = pd.DatetimeIndex(to_datetime64(t))
    return idx.year.to_numpy().astype(np.int32)


def month(t):
    import pandas as pd
    idx = pd.DatetimeIndex(to_datetime64(t))
    return idx.month.to_numpy().astype(np.int32)


def day_of_year(t):
    import pandas as pd
    idx = pd.DatetimeIndex(to_datetime64(t))
    return idx.dayofyear.to_numpy().astype(np.int32)


def week_window(week, window=1):
    """Weeks pooled for a target week, with the reference's 53-week
    wraparound ``(week + i) % 53 or 53`` (preprocessing.py:114)."""
    return [((week + i) % N_ISO_WEEKS) or N_ISO_WEEKS
            for i in range(-window, window + 1)]


def week_window_matrix(window=1):
    """(53, 53) boolean: pool[w-1, v-1] == True iff ISO week v is inside the
    rolling window of target week w. Precomputed once; the on-device labeler
    contracts it against the per-sample week one-hot."""
    m = np.zeros((N_ISO_WEEKS, N_ISO_WEEKS), dtype=bool)
    for w in range(1, N_ISO_WEEKS + 1):
        for v in week_window(w, window):
            m[w - 1, v - 1] = True
    return m


MONTHS = {"Jan": 1, "Feb": 2, "Mar": 3, "Apr": 4, "May": 5, "Jun": 6,
          "Jul": 7, "Aug": 8, "Sep": 9, "Oct": 10, "Nov": 11, "Dec": 12}


def season_months(season):
    """'May-Sep' -> [5, 6, 7, 8, 9]. Matches the month-window arithmetic in
    the reference's obs path (dataloader.py:484-487)."""
    a, b = season.split("-")
    return list(range(MONTHS[a], MONTHS[b] + 1))


def weekly_mondays(years, season):
    """Weekly (7-day-strided) init dates covering `season` for each year in
    the closed range `years` = (first, last). Used by the synthetic data
    generator to emulate the IRIDL S grid (7-day STEP, dataloader.py:28)."""
    import pandas as pd
    months = set(season_months(season))
    first, last = years
    out = []
    for yr in range(first, last + 1):
        d = pd.Timestamp(year=yr, month=1, day=1)
        d += pd.Timedelta(days=(7 - d.dayofweek) % 7)  # first Monday
        while d.year == yr:
            if d.month in months:
                out.append(d)
            d += pd.Timedelta(days=7)
    return pd.DatetimeIndex(out).values
