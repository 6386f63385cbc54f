"""Leveled logger with static (process-wide) configuration.

Mirrors the behaviour of the reference ``utils::Logger``
(reference: src/sparsebase/utils/logger.h:10-48, logger.cc:13-66): a
process-global level, stdout/stderr toggles, an optional log file, and
messages prefixed ``[time][level][root-type]``. Built on Python ``logging``
so it composes with host applications.
"""

from __future__ import annotations

import enum
import sys
import time
from typing import IO, Optional


class LogLevel(enum.IntEnum):
    LOG_LVL_INFO = 0
    LOG_LVL_WARNING = 1
    LOG_LVL_NONE = 2


# Convenience aliases matching the reference enum spellings.
LOG_LVL_INFO = LogLevel.LOG_LVL_INFO
LOG_LVL_WARNING = LogLevel.LOG_LVL_WARNING
LOG_LVL_NONE = LogLevel.LOG_LVL_NONE


class Logger:
    """Process-global leveled logger.

    Usage mirrors the reference::

        Logger.set_level(LogLevel.LOG_LVL_WARNING)
        log = Logger(MyClass)
        log.log("something happened", LogLevel.LOG_LVL_WARNING)
    """

    _level: LogLevel = LogLevel.LOG_LVL_WARNING
    _use_stdout: bool = True
    _use_stderr: bool = False
    _file: Optional[IO[str]] = None
    _filename: Optional[str] = None

    def __init__(self, root: object = None):
        if root is None:
            self._root = "sparsebase"
        elif isinstance(root, str):
            self._root = root
        elif isinstance(root, type):
            self._root = root.__name__
        else:
            self._root = type(root).__name__

    # -- static configuration ------------------------------------------------
    @classmethod
    def set_level(cls, level: LogLevel) -> None:
        cls._level = LogLevel(level)

    @classmethod
    def get_level(cls) -> LogLevel:
        return cls._level

    @classmethod
    def set_stdout(cls, use: bool) -> None:
        cls._use_stdout = use

    @classmethod
    def set_stderr(cls, use: bool) -> None:
        cls._use_stderr = use

    @classmethod
    def set_file(cls, filename: Optional[str]) -> None:
        if cls._file is not None:
            cls._file.close()
            cls._file = None
        cls._filename = filename
        if filename is not None:
            cls._file = open(filename, "a")

    # -- logging -------------------------------------------------------------
    def log(self, message: str, level: LogLevel = LogLevel.LOG_LVL_INFO) -> None:
        level = LogLevel(level)
        if level == LogLevel.LOG_LVL_NONE:
            raise ValueError("Cannot log at level LOG_LVL_NONE")
        if level < Logger._level:
            return
        stamp = time.strftime("%H:%M:%S")
        tag = {LogLevel.LOG_LVL_INFO: "INFO", LogLevel.LOG_LVL_WARNING: "WARNING"}[level]
        line = f"[{stamp}][{tag}][{self._root}] {message}"
        if Logger._use_stdout:
            print(line, file=sys.stdout)
        if Logger._use_stderr:
            print(line, file=sys.stderr)
        if Logger._file is not None:
            Logger._file.write(line + "\n")
            Logger._file.flush()

    def info(self, message: str) -> None:
        self.log(message, LogLevel.LOG_LVL_INFO)

    def warning(self, message: str) -> None:
        self.log(message, LogLevel.LOG_LVL_WARNING)
