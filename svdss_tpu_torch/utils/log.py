"""stderr logging (spdlog-equivalent; reference main.cpp:24)."""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("svdss_tpu")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def set_verbose(verbose: bool) -> None:
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
