"""Environment-driven logging for the PyTorch port.

Parity target: reference ``backend/logger.py:14-122`` — a process-wide logger
whose level and per-file filtering are controlled by ``SMP_LOG_LEVEL``,
``SMP_LOG_ALLOW_FILES`` / ``SMP_LOG_BLOCK_FILES`` and ``SMP_LOG_HIDE_TIME``.
A copy of ``smdistributed_modelparallel_tpu/utils/logger.py`` with the same
environment variables (its rank-tagging ``rmsg`` waits for a multi-process
slice).
"""

import logging
import os
import sys

_LEVELS = {
    "off": logging.CRITICAL + 10,
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG - 5,
}

_LOGGER_NAME = "smp_tpu_torch"
_configured = False


class _RelpathFilter(logging.Filter):
    """Attach a repo-relative pathname and honor allow/block file lists."""

    def __init__(self, allow, block):
        super().__init__()
        self.allow = allow
        self.block = block

    def filter(self, record):
        path = record.pathname.replace(os.sep, "/")
        marker = "smdistributed_modelparallel_tpu_torch/"
        idx = path.rfind(marker)
        record.relpath = path[idx + len(marker):] if idx >= 0 else os.path.basename(path)
        name = os.path.basename(record.pathname)
        if self.allow and name not in self.allow and record.relpath not in self.allow:
            return False
        if self.block and (name in self.block or record.relpath in self.block):
            return False
        return True


def _parse_files(env_var):
    raw = os.environ.get(env_var, "")
    return {f.strip() for f in raw.split(",") if f.strip()}


def get_log_level():
    return _LEVELS.get(os.environ.get("SMP_LOG_LEVEL", "info").lower(), logging.INFO)


def get_logger():
    """Return the process-wide framework logger, configuring it on first use."""
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if _configured:
        return logger
    _configured = True
    logging.addLevelName(_LEVELS["trace"], "TRACE")
    logger.setLevel(get_log_level())
    logger.propagate = False
    handler = logging.StreamHandler(sys.stderr)
    hide_time = os.environ.get("SMP_LOG_HIDE_TIME", "0") in ("1", "true", "True")
    fmt = "[%(levelname)s" + ("" if hide_time else " %(asctime)s") + " %(relpath)s:%(lineno)d] %(message)s"
    handler.setFormatter(logging.Formatter(fmt, datefmt="%H:%M:%S"))
    handler.addFilter(_RelpathFilter(_parse_files("SMP_LOG_ALLOW_FILES"), _parse_files("SMP_LOG_BLOCK_FILES")))
    logger.addHandler(handler)
    return logger

