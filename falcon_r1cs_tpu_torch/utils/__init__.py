"""Auxiliary layer of the port: runtime config, per-section constraint
counters, and the entry points' device check."""

from .config import RuntimeConfig
from .counters import CounterLog, SectionDelta
from .device import DeviceUnavailableError, entry_device

__all__ = [
    "CounterLog",
    "DeviceUnavailableError",
    "RuntimeConfig",
    "SectionDelta",
    "entry_device",
]
