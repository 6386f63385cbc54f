"""Runtime configuration.

Counterpart of ``sparsebase_tpu/config.py`` (reference: the CMake options
behind ``config.h``, CMakeLists.txt:10-18). A process-global dataclass holds
the settings that the port reads: the two native-library toggles and the
log level. The JAX package's dtype defaults, ``use_device_kernels``,
``rcm_peripheral_search`` and ``sort_on_construction`` are read by no code
of either package, and its ``rcm_device_max_n`` and
``sparse_common_device_max_nnz`` guarded the TPU against long device
programs; the port has none of them, so ``set_config`` refuses those names
as it refuses any unknown field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # feature toggles (USE_* analogues)
    use_fastio: bool = True  # native C++ parser for the Pigo* readers and the MTX writer
    use_graphkit: bool = True  # native C++ host graph algorithms (RCM's host route)

    # logging
    log_level: Optional[str] = None  # "info" | "warning" | None (leave as it is)

    def apply(self) -> "Config":
        """Push settings into the subsystems that read them."""
        if self.log_level is not None:
            from .utils.logger import LogLevel, Logger

            Logger.set_level(
                {"info": LogLevel.LOG_LVL_INFO, "warning": LogLevel.LOG_LVL_WARNING}[self.log_level]
            )
        return self


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kw) -> Config:
    """Update global settings, e.g. ``set_config(use_fastio=False)``; an
    unknown name raises ``TypeError`` (``dataclasses.replace``)."""
    global _config
    _config = dataclasses.replace(_config, **kw).apply()
    return _config
