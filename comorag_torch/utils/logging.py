"""Logger factory (reference: logging_utils.py:12-26, without import-time
basicConfig side effects).

Copy of ``comorag_tpu/utils/logging.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("COMORAG_LOG_LEVEL", "WARNING").upper()
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("comorag_torch")
        root.addHandler(handler)
        root.setLevel(level)
        _configured = True
    return logging.getLogger(name)
