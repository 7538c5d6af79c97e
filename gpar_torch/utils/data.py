"""Dataset loaders (a copy of ``gpar_tpu/utils/data.py``, which the port
does not import) — the ``wbml.data.{eeg,exchange,jura,air_temp}`` loaders
used by the paper experiments (SURVEY.md §2.3.6).

The upstream loaders download their datasets on first use; nothing is
downloaded here, so each loader

1. reads the real dataset from ``data_dir`` if the user has placed the
   files there (same formats as upstream), otherwise
2. generates a *synthetic stand-in* with the same shape, missingness
   structure, and train/test split as the real data, so every example
   workload runs end-to-end offline.

Every loader returns NumPy arrays (inputs, train outputs with NaNs for
missing entries, and test targets), equal bit for bit to the JAX
package's, NaNs in the same places.
"""

import os

import numpy as np

__all__ = ["load_eeg", "load_exchange", "load_jura", "load_air_temp", "chain_functions"]


def chain_functions(x, p, seed=0, noise=0.05):
    """Closed-downwards synthetic chain: output i depends nonlinearly on
    output i-1 and the input (the GPAR generative structure; the shape of
    the reference's synthetic example, ``examples/paper/synthetic.py:16-20``)."""
    rng = np.random.default_rng(seed)
    cols = [-np.sin(10 * np.pi * (x + 1)) / (2 * x + 1) - x**4]
    for i in range(1, p):
        prev = cols[-1]
        cols.append(np.cos(prev) ** 2 + np.sin((i + 2) * x))
    f = np.stack(cols, axis=1)
    y = f + noise * rng.standard_normal(f.shape)
    return f, y


def _real_or_none(data_dir, filename):
    """Path to the real dataset file, or None (-> synthetic fallback).

    The loaders' contract (module docstring) is: real file if present,
    synthetic stand-in otherwise — including when ``data_dir`` is given
    but the file is absent (a warning is emitted then, rather than an
    exception, so every example runs end-to-end offline).
    """
    if data_dir is None:
        return None
    path = os.path.join(data_dir, filename)
    if os.path.exists(path):
        return path
    import warnings

    warnings.warn(
        f"{path} not found - falling back to the synthetic stand-in.",
        stacklevel=3,
    )
    return None


def load_eeg(data_dir=None, synthetic_seed=0):
    """EEG: 7 outputs (FZ, F1..F6), n=256, test = the last 100 samples of
    three of the outputs (structure of ``wbml.data.eeg``).

    Returns ``(x, y_train, y_test, columns)`` where ``y_train`` has NaNs at
    test positions and ``y_test`` has NaNs everywhere else.
    """
    columns = ["F3", "F4", "F5", "F6", "FZ", "F1", "F2"]
    path = _real_or_none(data_dir, "eeg.csv")
    if path is not None:
        raw = np.genfromtxt(path, delimiter=",", names=True)
        x = raw["time"]
        y = np.stack([raw[c] for c in columns], axis=1)
    else:
        rng = np.random.default_rng(synthetic_seed)
        n = 256
        x = np.linspace(0, 1, n)
        base = np.sin(2 * np.pi * 4 * x) + 0.3 * rng.standard_normal(n)
        y = np.stack(
            [base * (1 + 0.2 * i) + 0.2 * rng.standard_normal(n) for i in range(7)],
            axis=1,
        )

    test_cols = [columns.index(c) for c in ["F1", "F2", "FZ"]]
    n = len(x)
    # Clipped so short (fixture-sized) files hold out every row instead of
    # wrapping negative indices; the real dataset has n=256 > 100.
    test_rows = np.arange(max(0, n - 100), n)
    y_train = y.copy()
    y_test = np.full_like(y, np.nan)
    for c in test_cols:
        y_test[test_rows, c] = y[test_rows, c]
        y_train[test_rows, c] = np.nan
    return x, y_train, y_test, columns


def load_exchange(data_dir=None, synthetic_seed=0):
    """Exchange rates: 13 outputs over n=251 trading days of 2007; test =
    year fractions [0.2, 0.4] of CAD, [0.4, 0.6] of JPY, [0.6, 0.8] of AUD
    (structure of ``wbml.data.exchange``).
    """
    columns = [
        "USD/CHF", "USD/EUR", "USD/GBP", "USD/HKD", "USD/KRW", "USD/MXN",
        "USD/NZD", "USD/SEK", "USD/SGD", "USD/AUD", "USD/CAD", "USD/JPY",
        "USD/XAU",
    ]
    path = _real_or_none(data_dir, "exchange.csv")
    if path is not None:
        raw = np.genfromtxt(path, delimiter=",", names=True)
        x = raw["year"]
        y = np.stack([raw[c.replace("/", "_")] for c in columns], axis=1)
    else:
        rng = np.random.default_rng(synthetic_seed)
        n = 251
        x = 2007 + np.arange(n) / n
        t = np.linspace(0, 1, n)
        y = np.stack(
            [
                1.0
                + 0.1 * np.sin(2 * np.pi * (i + 1) * t / 4)
                + 0.02 * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
                for i in range(13)
            ],
            axis=1,
        )

    n = len(x)
    t_frac = (x - x.min()) / (x.max() - x.min())
    held = {"USD/CAD": (0.2, 0.4), "USD/JPY": (0.4, 0.6), "USD/AUD": (0.6, 0.8)}
    y_train = y.copy()
    y_test = np.full_like(y, np.nan)
    for name, (lo, hi) in held.items():
        c = columns.index(name)
        rows = (t_frac >= lo) & (t_frac < hi)
        y_test[rows, c] = y[rows, c]
        y_train[rows, c] = np.nan
    return x, y_train, y_test, columns


def load_jura(data_dir=None, synthetic_seed=0):
    """Jura geostatistics: 2-D spatial inputs; outputs (Ni, Zn, Cd); the
    test set holds out Cd at 100 locations where Ni and Zn remain observed
    (structure of ``wbml.data.jura``).

    Returns ``(x_train, y_train, x_test, y_test, columns)``.
    """
    columns = ["Ni", "Zn", "Cd"]
    path = _real_or_none(data_dir, "jura.csv")
    if path is not None:
        raw = np.genfromtxt(path, delimiter=",", names=True)
        x = np.stack([raw["x"], raw["y"]], axis=1)
        y = np.stack([raw[c] for c in columns], axis=1)
    else:
        rng = np.random.default_rng(synthetic_seed)
        n = 359
        x = rng.uniform(0, 5, size=(n, 2))
        base = np.exp(np.sin(x[:, 0]) + np.cos(1.3 * x[:, 1]))
        ni = 20 * base + rng.standard_normal(n)
        zn = 75 * base + 3 * rng.standard_normal(n)
        cd = 1.3 * np.sqrt(np.abs(base)) + 0.1 * rng.standard_normal(n)
        y = np.stack([ni, zn, np.abs(cd)], axis=1)

    n = len(x)
    n_test = 100
    rng = np.random.default_rng(12345)
    test_rows = rng.permutation(n)[:n_test]
    # Cd is missing at the test locations but Ni/Zn stay observed there.
    y_train = y.copy()
    y_train[test_rows, columns.index("Cd")] = np.nan
    x_test = x[test_rows]
    y_test = y[test_rows]
    return x, y_train, x_test, y_test, columns


def load_air_temp(data_dir=None, size=0, synthetic_seed=0):
    """Air temperature: 4 outputs (Bra, Cam, Chi, Sot); three dataset sizes
    (10/15/31 days at hourly resolution); per-size test windows where two
    outputs are held out (structure of ``wbml.data.air_temp``).

    Returns ``(x_all, x_train, y_train, tests)`` with ``tests`` a list of
    ``(x_test, y_test)`` chunks, inputs in days.
    """
    days = [10, 15, 31][size]
    n = days * 24 * 6  # 10-minute resolution
    path = _real_or_none(data_dir, f"air_temp_{days}.csv")
    if path is not None:
        raw = np.genfromtxt(path, delimiter=",", names=True)
        x = raw["day"]
        y = np.stack([raw[c] for c in ["Bra", "Cam", "Chi", "Sot"]], axis=1)
    else:
        rng = np.random.default_rng(synthetic_seed)
        x = np.arange(n) / (24 * 6)
        daily = 10 + 8 * np.sin(2 * np.pi * (x - 0.3))
        y = np.stack(
            [
                daily
                + i
                + 0.8 * np.sin(2 * np.pi * (x - 0.1 * i))
                + 0.5 * rng.standard_normal(n)
                for i in range(4)
            ],
            axis=1,
        )

    # Hold out the final two days of outputs 2 and 3 as two test chunks.
    y_train = y.copy()
    tests = []
    for k, c in enumerate([2, 3]):
        # Upper bound inclusive for the final chunk so x == x.max() is
        # held out rather than leaking into training.
        upper = x <= x.max() - k if k == 0 else x < x.max() - k
        rows = (x >= x.max() - (k + 1)) & upper
        # Same contract as load_eeg/load_exchange: y_test is NaN except at
        # the held-out entries, so NaN-aware metrics score only the
        # genuinely held-out output (not columns that were in training).
        y_t = np.full_like(y, np.nan)
        y_t[rows, c] = y[rows, c]
        y_train[rows, c] = np.nan
        tests.append((x[rows], y_t[rows]))
    return x, x, y_train, tests
