"""Console and file logger with a JSONL metric stream.

Counterpart of fabind_tpu/utils/logging_utils.py `Logger`: messages go to
stdout and `<log_dir>/log.txt`, metrics to `<log_dir>/metrics.jsonl` (one
JSON object per record: ts, phase, step and the values) and, when
`torch.utils.tensorboard` imports, to TensorBoard under `<log_dir>/tsb`.
Weights & Biases is not wired in.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


class Logger:
    def __init__(self, log_dir: Optional[str] = None,
                 name: str = "fabind_tpu_torch"):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        for h in list(self.logger.handlers):
            h.close()
        self.logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        self.jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, "tsb"))
            except Exception:
                self._tb = None

    def log_message(self, msg: str) -> None:
        self.logger.info(msg)

    def log_metrics(self, metrics: Dict[str, float], step: int,
                    phase: str = "train") -> None:
        clean = {k: (float(v) if hasattr(v, "item")
                     or isinstance(v, (int, float)) else v)
                 for k, v in metrics.items()}
        parts = ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in sorted(clean.items()))
        self.logger.info(f"[{phase} step {step}] {parts}")
        if self.jsonl:
            rec = {"ts": time.time(), "phase": phase, "step": step, **clean}
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self._tb:
            for k, v in clean.items():
                if isinstance(v, float):
                    self._tb.add_scalar(f"{phase}/{k}", v, step)

    def close(self) -> None:
        """Close the files (the stdout handler stays)."""
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
        for h in list(self.logger.handlers):
            if isinstance(h, logging.FileHandler):
                h.close()
                self.logger.removeHandler(h)
