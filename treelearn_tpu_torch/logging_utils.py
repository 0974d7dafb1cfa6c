"""Logging and scalar metrics.

Parity: reference tree_learn/util/logger.py (singleton stdlib logger + file
handler + tensorboard writer).  tensorboardX may be absent in this image, so the
scalar writer also mirrors everything into a JSONL file under the work dir, which
doubles as a machine-readable training trace.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Optional


def get_root_logger(log_file: Optional[str] = None, log_level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("TreeLearnTPU")
    if logger.hasHandlers():
        return logger

    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(message)s", level=log_level
    )
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        file_handler = logging.FileHandler(log_file, "w")
        file_handler.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        )
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    return logger


class ScalarWriter:
    """Scalar logger: JSONL always; tensorboardX if importable."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step), "ts": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def init_train_logger(cfg, args):
    """Create work dir, timestamped file log, copy config for provenance
    (parity: reference logger.py:35-45)."""
    save_directory = cfg.work_dir
    os.makedirs(os.path.abspath(save_directory), exist_ok=True)
    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    log_file = os.path.join(save_directory, f"{timestamp}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(f"Config:\n{cfg}")
    if getattr(args, "config", None):
        shutil.copy(args.config, os.path.join(cfg.work_dir, os.path.basename(args.config)))
    writer = ScalarWriter(save_directory)
    return logger, writer
