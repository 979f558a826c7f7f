"""Environment-driven paths: ``RESULTS_DIR`` from the environment or a
``.env`` file in the working directory (default ``results``)."""

from __future__ import annotations

import os


def _dotenv(path: str = ".env") -> dict:
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip().strip("'\"")
    return out


def results_dir() -> str:
    return os.environ.get("RESULTS_DIR") or _dotenv().get("RESULTS_DIR",
                                                           "results")
