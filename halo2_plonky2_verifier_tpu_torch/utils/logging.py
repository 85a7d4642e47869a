"""Leveled, env-controlled logging: a copy of
`halo2_plonky2_verifier_tpu/utils/logging.py` (the framework's
`env_logger` analog), with the same `HALO2_TPU_LOG` grammar and levels:

    HALO2_TPU_LOG=info python3 tools/torch_serve.py --self-test
    HALO2_TPU_LOG=halo2_plonky2_verifier_tpu_torch.parallel=debug,info ...

Levels: error < warn < info < debug < trace.  Default: warn (silent in
normal library use).  Per-module overrides use `module=level` entries, most
specific prefix wins.

`log = get_logger(__name__)`; a disabled call costs one integer compare.
All output goes to stderr with a monotonic timestamp, so that stdout (the
service's JSON lines, `chip_smoke.py`'s result lines) stays
machine-readable.
"""

import os
import sys
import time

ERROR, WARN, INFO, DEBUG, TRACE = 10, 20, 30, 40, 50
_NAMES = {"error": ERROR, "warn": WARN, "warning": WARN, "info": INFO,
          "debug": DEBUG, "trace": TRACE}
_LABEL = {ERROR: "ERROR", WARN: "WARN", INFO: "INFO", DEBUG: "DEBUG",
          TRACE: "TRACE"}

_T0 = time.monotonic()


def _parse(spec):
    """'info' or 'mod.path=debug,other=trace,warn' -> (default, {prefix: lvl})."""
    default = WARN
    per_module = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            mod, _, lvl = part.partition("=")
            if lvl.strip().lower() in _NAMES:
                per_module[mod.strip()] = _NAMES[lvl.strip().lower()]
        elif part.lower() in _NAMES:
            default = _NAMES[part.lower()]
    return default, per_module


_DEFAULT, _PER_MODULE = _parse(os.environ.get("HALO2_TPU_LOG"))


def set_level(spec):
    """Programmatic override with the same grammar as HALO2_TPU_LOG."""
    global _DEFAULT, _PER_MODULE
    _DEFAULT, _PER_MODULE = _parse(spec)


def _level_for(name):
    best, best_len = _DEFAULT, -1
    for prefix, lvl in _PER_MODULE.items():
        if name.startswith(prefix) and len(prefix) > best_len:
            best, best_len = lvl, len(prefix)
    return best


class Logger:
    __slots__ = ("name", "_short")

    def __init__(self, name):
        self.name = name
        self._short = name.replace("halo2_plonky2_verifier_tpu_torch.", "")

    def enabled(self, level):
        return level <= _level_for(self.name)

    def _emit(self, level, msg, args):
        if level > _level_for(self.name):
            return
        if args:
            msg = msg % args
        print(f"[{time.monotonic() - _T0:9.3f}s {_LABEL[level]:5s} "
              f"{self._short}] {msg}", file=sys.stderr, flush=True)

    def error(self, msg, *args):
        self._emit(ERROR, msg, args)

    def warn(self, msg, *args):
        self._emit(WARN, msg, args)

    warning = warn

    def info(self, msg, *args):
        self._emit(INFO, msg, args)

    def debug(self, msg, *args):
        self._emit(DEBUG, msg, args)

    def trace(self, msg, *args):
        self._emit(TRACE, msg, args)


_LOGGERS = {}


def get_logger(name):
    if name not in _LOGGERS:
        _LOGGERS[name] = Logger(name)
    return _LOGGERS[name]
