"""Named loggers with console + per-name file handlers.

Behavioural parity with reference src/core/logger.py:7-50: each named logger
writes to the console and to ``logs/{name}.log``; the level can be overridden
with the ``VIDGRAPH_LOG_LEVEL`` environment variable.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

_FMT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def _resolve_level(default: int = logging.INFO) -> int:
    env = os.environ.get("VIDGRAPH_LOG_LEVEL", "").upper()
    if env and hasattr(logging, env):
        return getattr(logging, env)
    return default


def get_logger(name: str, log_dir: Optional[str] = "logs",
               level: Optional[int] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_vidgraph_configured", False):
        return logger

    logger.setLevel(level if level is not None else _resolve_level())
    logger.propagate = False
    formatter = logging.Formatter(_FMT)

    console = logging.StreamHandler()
    console.setFormatter(formatter)
    logger.addHandler(console)

    if log_dir is not None:
        try:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(Path(log_dir) / f"{name}.log")
            fh.setFormatter(formatter)
            logger.addHandler(fh)
        except OSError:
            pass  # read-only FS etc. — console logging still works

    logger._vidgraph_configured = True  # type: ignore[attr-defined]
    return logger
