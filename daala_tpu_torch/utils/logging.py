"""Facility/level logging, environment-configured.

Behavioral parity with the reference's logging layer (reference:
src/logging.h:40-127, src/logging.c): a fixed facility enum, numeric
levels 1 (err) .. 5 (debug), per-facility thresholds parsed from the
OD_LOG_MODULES environment variable ("<facility>:<level>,..."), a
pluggable sink function, and matrix-dump helpers.  Messages are emitted
when the per-facility threshold is >= the message level.

Unlike the reference (compiled out unless --enable-logging), this is
always available but zero-cost when no facility is enabled:
`od_logging_active(fac, level)` is a dict lookup.

The port's copy of daala_tpu/utils/logging.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import os
import sys

# Facility enum (reference: src/logging.h:41-52).
OD_LOG_GENERIC = 0
OD_LOG_ENCODER = 1
OD_LOG_MOTION_ESTIMATION = 2
OD_LOG_MOTION_COMPENSATION = 3
OD_LOG_ENTROPY_CODER = 4
OD_LOG_PVQ = 5
OD_LOG_FILTER = 6
OD_LOG_FACILITY_MAX = 7

_FACILITY_NAMES = ["generic", "encoder", "motion-estimation",
                   "motion-compensation", "entropy-coder", "pvq", "filter"]

# Levels (reference: src/logging.h:59-67).
OD_LOG_ERR = 1
OD_LOG_WARN = 2
OD_LOG_NOTICE = 3
OD_LOG_INFO = 4
OD_LOG_DEBUG = 5

_levels = [0] * OD_LOG_FACILITY_MAX
_logger = None
_inited = False


def _default_logger(facility, level, msg):
    name = (_FACILITY_NAMES[facility]
            if 0 <= facility < OD_LOG_FACILITY_MAX else "?")
    sys.stderr.write("[%s/%d] %s\n" % (name, level, msg))
    return 0


def od_log_init(logger=None, env=None):
    """Parse OD_LOG_MODULES ("facility:level,facility:level") and install
    the sink (reference: src/logging.c od_log_init).  Unknown facility
    names are ignored, matching the reference's tolerant parser."""
    global _logger, _inited
    _logger = logger or _default_logger
    spec = env if env is not None else os.environ.get("OD_LOG_MODULES", "")
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, lvl = part.rpartition(":")
        try:
            lvl = int(lvl)
        except ValueError:
            continue
        name = name.strip()
        if name in _FACILITY_NAMES:
            _levels[_FACILITY_NAMES.index(name)] = lvl
    _inited = True
    return 0


def od_logging_active(facility, level):
    """True iff a message at `level` for `facility` would be emitted."""
    if not _inited:
        od_log_init()
    return 0 <= facility < OD_LOG_FACILITY_MAX and \
        _levels[facility] >= level


def od_log(facility, level, fmt, *args):
    """Emit one log line (printf-style) if the facility is active."""
    if not od_logging_active(facility, level):
        return 0
    return _logger(facility, level, (fmt % args) if args else fmt)


def od_log_matrix(facility, level, prefix, mat):
    """Dump a 2-D integer matrix row per line (reference:
    src/logging.c od_log_matrix_* helpers)."""
    if not od_logging_active(facility, level):
        return 0
    for row in mat:
        od_log(facility, level,
               "%s%s", prefix, " ".join(str(int(v)) for v in row))
    return 0


def reset_for_tests():
    global _inited
    _inited = False
    for i in range(OD_LOG_FACILITY_MAX):
        _levels[i] = 0
