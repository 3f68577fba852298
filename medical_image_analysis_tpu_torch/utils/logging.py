"""Metric logging: smoothed windows, ETA, CSV/JSONL writers.

Replaces the reference's ``MetricLogger``/``SmoothedValue``
(``CXPMRG.../pretrain/utils/misc.py:19-163``) and Lightning's CSV/TB
loggers (``lightning_tools/callbacks.py:22-28``): same log_every shape
(iter time, data time, ETA, loss window), JSON-lines ``log.txt`` on the
host (``main_pretrain.py:201-205``). Cross-process reduction is
unnecessary on one device. A copy of
``medical_image_analysis_tpu/utils/logging.py``.
"""

from __future__ import annotations

import collections
import csv
import datetime
import json
import os
import time
from typing import Iterable


class SmoothedValue:
    """Windowed metric meter.

    ``update`` accepts plain floats OR device scalars and does NOT read
    device values: converting a step's loss to ``float`` on every
    iteration blocks the host on that step's completion, which defeats
    asynchronous launches. Pending values are drained to floats lazily,
    the first time a statistic is read (log boundaries, epoch ends).
    """

    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self._pending: list = []

    def update(self, value, n: int = 1):
        self._pending.append((value, n))

    def _drain(self):
        for value, n in self._pending:
            v = float(value)
            self.deque.append(v)
            self.total += v * n
            self.count += n
        self._pending.clear()

    @property
    def avg(self) -> float:
        self._drain()
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        self._drain()
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue
        )
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v)  # device scalars stay unread

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: int | None = None):
        i = 0
        start = time.time()
        iter_time = SmoothedValue()
        data_time = SmoothedValue()
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                else:
                    eta_s = "?"
                meters = self.delimiter.join(
                    f"{k}: {m.avg:.4f}" for k, m in self.meters.items()
                )
                print(
                    f"{header} [{i}{'/' + str(total) if total else ''}]  "
                    f"eta: {eta_s}  {meters}  "
                    f"time: {iter_time.avg:.4f}  data: {data_time.avg:.4f}",
                    flush=True,
                )
            i += 1
            end = time.time()
        print(
            f"{header} done in {time.time() - start:.1f}s", flush=True
        )


class JsonlLogger:
    """log.txt JSON-lines (main_pretrain.py:201-205) + CSV mirror."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "log.txt")
        self.csv_path = os.path.join(out_dir, "metrics.csv")
        self._csv_fields: list[str] | None = None

    def write(self, record: dict):
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._csv_fields is None:
            self._csv_fields = list(record.keys())
            with open(self.csv_path, "a", newline="") as f:
                csv.writer(f).writerow(self._csv_fields)
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [record.get(k, "") for k in self._csv_fields]
            )
