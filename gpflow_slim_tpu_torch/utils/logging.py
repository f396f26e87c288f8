"""Metrics logging (counterpart of ``gpflow_slim_tpu.utils.logging``).

``MetricsLogger`` appends one row a call to a JSONL (default) or CSV file,
between training segments; tensors are read back to the host as numbers or
lists. ESS and R-hat live in ``mcmc.diagnostics``.
"""

from __future__ import annotations

import csv
import json
import os
import time

import numpy as np
import torch

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL (default) or CSV metrics writer; a context manager
    that closes its file on exit."""

    def __init__(self, path: str, fmt: str = "jsonl"):
        if fmt not in ("jsonl", "csv"):
            raise ValueError(fmt)
        self.path = path
        self.fmt = fmt
        self._csv_writer = None
        self._fh = None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _ensure_open(self, row):
        if self._fh is None:
            self._fh = open(self.path, "a")
            if self.fmt == "csv":
                self._csv_writer = csv.DictWriter(self._fh, fieldnames=list(row.keys()))
                if self._fh.tell() == 0:
                    self._csv_writer.writeheader()

    def log(self, step: int, **metrics):
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            row[k] = float(v) if v.ndim == 0 else v.tolist()
        self._ensure_open(row)
        if self.fmt == "jsonl":
            self._fh.write(json.dumps(row) + "\n")
        else:
            self._csv_writer.writerow(row)
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
