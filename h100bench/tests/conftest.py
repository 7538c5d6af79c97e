"""The benchmark's tests compute with one thread a process: the whole runs
of ``test_h100bench_faults.py`` go in parallel (``pytest -n``), and threads
that outnumber the cores slow every run many times over."""

import torch

torch.set_num_threads(1)
