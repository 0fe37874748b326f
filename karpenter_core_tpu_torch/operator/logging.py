"""Structured logging (ref pkg/operator/logging/logging.go): zap-style
leveled logger with key-value context.

The port's copy of ``karpenter_core_tpu/operator/logging.py``; the port's
operator logs as ``karpenter.torch.controller``."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO, "warn": logging.WARNING, "error": logging.ERROR}


class StructuredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "level": record.levelname.lower(),
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "logger": record.name,
            "message": record.getMessage(),
        }
        extra = getattr(record, "kv", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


class Logger:
    """knative-style sugar: .with_(k=v) returns a child carrying context."""

    def __init__(self, name: str = "controller", level: str = "info", kv: Optional[dict] = None):
        self._logger = logging.getLogger(name)
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(StructuredFormatter())
            self._logger.addHandler(handler)
            self._logger.propagate = False
        self._logger.setLevel(_LEVELS.get(level, logging.INFO))
        self.kv = kv or {}

    def set_level(self, level: str) -> None:
        self._logger.setLevel(_LEVELS.get(level, logging.INFO))

    def with_(self, **kv) -> "Logger":
        child = Logger.__new__(Logger)
        child._logger = self._logger
        child.kv = {**self.kv, **kv}
        return child

    def _log(self, level: int, msg: str, *args) -> None:
        self._logger.log(level, msg % args if args else msg, extra={"kv": self.kv})

    def debug(self, msg: str, *args) -> None:
        self._log(logging.DEBUG, msg, *args)

    def info(self, msg: str, *args) -> None:
        self._log(logging.INFO, msg, *args)

    def warn(self, msg: str, *args) -> None:
        self._log(logging.WARNING, msg, *args)

    def error(self, msg: str, *args) -> None:
        self._log(logging.ERROR, msg, *args)


def new_logger(level: str = "info") -> Logger:
    return Logger(name="karpenter.torch.controller", level=level)


CONFIG_NAME = "config-logging"


def watch_config_logging(
    kube_client, logger: Logger, component: str = "controller", namespace: str = "default"
):
    """Drive the log level from the system namespace's ``config-logging``
    ConfigMap, live. The reference loads the same keys once at startup
    from mounted files (pkg/operator/logging/logging.go:47-167:
    ``loglevel.<component>`` wins, else the zap config JSON's "level")
    and fails hard on bad config; this build extends that to a live
    knative-observer-style watch, so bad config is rejected loudly but
    non-fatally instead. Only the operator's own namespace is honored —
    any other namespace's config-logging is ignored. Returns the
    watch's unsubscribe fn."""

    # the level to fall back to when the ConfigMap stops selecting one
    # (key removed, config deleted) — live config must be revertible
    base_level = logger._logger.level

    def _reject(value) -> None:
        # error level so the rejection survives whatever level the
        # (possibly broken) config itself selected
        logger.error("ignoring invalid log level %r from %s ConfigMap", value, CONFIG_NAME)

    def _apply(cm) -> None:
        # user-authored config: malformed JSON / non-dict / unknown
        # levels must never take down the watch (or Operator.__init__,
        # which receives a synchronous ADDED replay)
        try:
            level = cm.data.get(f"loglevel.{component}")
            if level is not None and level not in _LEVELS:
                _reject(level)  # bad override: reject, then fall back
                level = None
            if not level:
                raw = cm.data.get("zap-logger-config")
                if raw:
                    parsed = json.loads(raw)
                    if not isinstance(parsed, dict):
                        _reject(parsed)
                    else:
                        level = parsed.get("level")
                        if level is not None and not (isinstance(level, str) and level in _LEVELS):
                            _reject(level)
                            level = None
            if level:
                logger.set_level(level)
            else:
                logger._logger.setLevel(base_level)
        except Exception:
            logger.error("ignoring malformed %s ConfigMap", CONFIG_NAME)

    def _on_event(event: str, obj) -> None:
        if obj.name != CONFIG_NAME or obj.namespace != namespace:
            return
        if event in ("ADDED", "MODIFIED"):
            _apply(obj)
        elif event == "DELETED":
            logger._logger.setLevel(base_level)

    return kube_client.watch("ConfigMap", _on_event)
