"""Experiment utilities (a copy of ``gpar_tpu/utils/experiment.py``, which
the port does not import) — the ``wbml.experiment`` / ``wbml.out`` surface
the reference examples use (``WorkingDirectory`` + pickle persistence at
``examples/paper/air_temp.py:20,59``; ``Counter`` progress bars at
``gpar/regression.py:417,558``; ``out.kv`` reporting).

NumPy only.  The printed text, the ``SystemExit`` message of
:func:`check_metric` and the pickles of :class:`WorkingDirectory` are the
JAX package's, byte for byte.
"""

import os
import pickle
import sys
import time

import numpy as np

__all__ = ["WorkingDirectory", "Counter", "check_metric", "kv", "report_time"]

#: When True, progress/kv output is prefixed with a timestamp
#: (``wbml.out.report_time``, ``examples/paper/eeg.py:13``).
report_time = False


def _stamp():
    if report_time:
        return time.strftime("[%Y-%m-%d %H:%M:%S] ")
    return ""


def kv(key, value):
    """Key-value report line (``wbml.out.kv``)."""
    if isinstance(value, (np.ndarray, list, tuple)):
        value = np.array2string(np.asarray(value), precision=4)
    elif isinstance(value, float):
        value = f"{value:.6g}"
    print(f"{_stamp()}{key}: {value}")


def check_metric(name, value, bound, larger_is_worse=True):
    """Golden quality gate for example workloads (the ``--check`` flag).

    The reference's examples print their metrics at runtime without
    committing expected values (SURVEY.md §6); this makes the seeded
    synthetic stand-ins regression-proof: CI runs the examples with
    ``--check`` and a metric outside its committed envelope aborts with a
    non-zero exit.
    """
    value = float(value)
    ok = value <= bound if larger_is_worse else value >= bound
    rel = "<=" if larger_is_worse else ">="
    status = "ok" if ok else "FAIL"
    print(f"{_stamp()}[check] {name}: {value:.6g} {rel} {bound:.6g} ... {status}")
    if not ok:
        raise SystemExit(
            f"Quality gate failed: {name} = {value:.6g}, expected {rel} "
            f"{bound:.6g} (committed golden envelope)"
        )


class WorkingDirectory:
    """Seeded output directory with pickle save/load.

    ``WorkingDirectory("_experiments", "air_temp", seed=1)`` creates the
    nested directory, optionally seeds NumPy, and exposes ``file`` /
    ``save`` / ``load``.
    """

    def __init__(self, *parts, seed=None):
        self.path = os.path.join(*parts)
        os.makedirs(self.path, exist_ok=True)
        if seed is not None:
            np.random.seed(seed)

    def file(self, *name):
        """Path of a file inside the directory (subdirs created)."""
        path = os.path.join(self.path, *name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def save(self, obj, *name):
        with open(self.file(*name), "wb") as f:
            pickle.dump(obj, f)

    def load(self, *name):
        with open(self.file(*name), "rb") as f:
            return pickle.load(f)


class Counter:
    """Progress counter context manager (``wbml.out.Counter``)."""

    def __init__(self, name="Progress", total=None, verbose=True):
        self.name = name
        self.total = total
        self.i = 0
        self.verbose = verbose

    def __enter__(self):
        if self.verbose:
            total = f"/{self.total}" if self.total else ""
            print(f"{_stamp()}{self.name}: 0{total}", end="", flush=True)
        return self

    def count(self):
        self.i += 1
        if self.verbose:
            total = f"/{self.total}" if self.total else ""
            print(f"\r{_stamp()}{self.name}: {self.i}{total}", end="", flush=True)

    def __exit__(self, *exc):
        if self.verbose:
            print(file=sys.stdout)
        return False
