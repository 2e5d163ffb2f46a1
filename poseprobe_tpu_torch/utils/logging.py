"""Metrics logging: a JSONL stream, TensorBoard where it is installed, and a
phase timer.

Port of `poseprobe_tpu/utils/logging.py`.
"""
from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Appends one JSON line per `log` call (with the seconds since the
    logger was made) to `jsonl_path`, and the numeric values as TensorBoard
    scalars under ``train/`` when `tensorboard_dir` is given and
    `torch.utils.tensorboard` imports."""

    def __init__(self, jsonl_path: str, tensorboard_dir: str | None = None):
        os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
        self._f = open(jsonl_path, "a")
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("[logging] torch.utils.tensorboard is not installed: JSONL only")
            else:
                self._tb = SummaryWriter(log_dir=tensorboard_dir)
        self._t0 = time.time()

    def log(self, metrics: dict) -> None:
        rec = dict(metrics)
        rec["wall_time"] = round(time.time() - self._t0, 3)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            step = int(metrics.get("step", 0))
            for k, v in metrics.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(f"train/{k}", v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class Timer:
    """Phase timer: `lap(name)` adds the seconds since the last lap to `laps[name]`."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: dict[str, float] = {}

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.t
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self.t = now
        return dt
