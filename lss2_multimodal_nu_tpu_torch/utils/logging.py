"""Metric logging: `<run_name>.jsonl` and `<run_name>.csv` in the log
directory, rows as the JAX package's `utils/logging.py::MetricLogger`
writes them, and wandb when it is asked for and installed (imported only
then)."""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def _scalar(v) -> bool:
    return isinstance(v, (int, float, str)) or (hasattr(v, "item") and getattr(v, "ndim", 0) == 0)


def _host_array(v) -> np.ndarray:
    """v (a numpy array, a tensor on any device, a sequence) as numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class MetricLogger:
    """Appends one row a `log` call: `step`, `time` and every scalar metric
    to the JSONL file and the CSV file (whose columns are the first row's);
    with wandb, scalars as numbers and arrays as histograms."""

    def __init__(self, logdir: str, run_name: str = "run", use_wandb: bool = False,
                 wandb_config: Optional[Dict] = None, wandb_name: Optional[str] = None):
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, f"{run_name}.jsonl"), "a")
        self.csv_path = os.path.join(logdir, f"{run_name}.csv")
        self._csv_fields = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb not installed; continuing without it")
            else:
                self._wandb = wandb
                wandb.init(project=run_name, config=wandb_config or {},
                           **({"name": wandb_name} if wandb_name else {}))

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "time": time.time(), **{
            k: (float(v) if not isinstance(v, str) else v)
            for k, v in metrics.items() if _scalar(v)
        }}
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()
        if self._csv_fields is None:
            self._csv_fields = list(row.keys())
            write_header = (not os.path.exists(self.csv_path)
                            or os.path.getsize(self.csv_path) == 0)
            self._csv = open(self.csv_path, "a", newline="")
            self._writer = csv.DictWriter(self._csv, fieldnames=self._csv_fields,
                                          extrasaction="ignore")
            if write_header:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._csv.flush()
        if self._wandb:
            def render(v):
                if _scalar(v):
                    return v if isinstance(v, str) else float(v)
                return self._wandb.Histogram(_host_array(v).reshape(-1))

            self._wandb.log({k: render(v) for k, v in metrics.items()}, step=step)

    def close(self) -> None:
        self.jsonl.close()
        if self._csv_fields is not None:
            self._csv.close()
        if self._wandb:
            self._wandb.finish()
