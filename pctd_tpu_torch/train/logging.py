"""Run directories and metric writers (a copy of
``pctd_tpu/train/logging.py``, the same layout and ``metrics.csv``): a
``result_<date>_<time>/`` run directory with ``writers/`` and ``models/``
subdirectories and the entry script copied in as ``readme.txt``, and one
scalar stream per metric name for the train and val tasks. TensorBoard
(tensorboardX) is written when it is installed; the CSV stream always is.
"""
from __future__ import annotations

import csv
import datetime
import os
import shutil
from typing import Dict, Iterable, Optional


class RunPaths:
    def __init__(self, readme_fn: Optional[str] = None,
                 root: str = "result", with_date: bool = True,
                 base_dir: str = "."):
        stamp = ""
        if with_date:
            now = datetime.datetime.now()
            stamp = f"_{now.date()}_{now.strftime('%H%M%S')}"
        self.log_path = os.path.join(base_dir, f"{root}{stamp}")
        self.writer_path = os.path.join(self.log_path, "writers")
        self.model_path_dir = os.path.join(self.log_path, "models")
        for p in (self.log_path, self.writer_path, self.model_path_dir):
            os.makedirs(p, exist_ok=True)
        if readme_fn is not None and os.path.exists(readme_fn):
            shutil.copyfile(readme_fn,
                            os.path.join(self.log_path, "readme.txt"))

    def model_path(self, name: str, tag: str) -> str:
        return os.path.join(self.model_path_dir, f"{name}_{tag}")


class MetricWriters:
    """Per-metric scalar writers for 'train'/'val' tasks."""

    def __init__(self, writer_names: Iterable[str], log_path: str,
                 use_tensorboard: bool = True):
        self.writer_names = list(writer_names)
        self.log_path = log_path
        os.makedirs(log_path, exist_ok=True)
        self._tb = {}
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                for name in self.writer_names:
                    self._tb[name] = SummaryWriter(
                        os.path.join(log_path, name))
            except ImportError:
                pass
        self._csv_file = open(os.path.join(log_path, "metrics.csv"), "w",
                              newline="")
        self._csv = csv.writer(self._csv_file)
        self._csv.writerow(["task", "step"] + self.writer_names)

    def write_task(self, task: str, vals: Dict[str, float], step: int):
        for name in self.writer_names:
            if name in self._tb and name in vals:
                self._tb[name].add_scalar(f"{task}_loss", vals[name], step)
        self._csv.writerow([task, step] +
                           [vals.get(n, "") for n in self.writer_names])
        self._csv_file.flush()

    def close(self):
        for w in self._tb.values():
            w.close()
        self._csv_file.close()
