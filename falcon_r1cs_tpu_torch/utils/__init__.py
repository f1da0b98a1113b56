"""Runtime configuration of the port."""

from .config import RuntimeConfig

__all__ = ["RuntimeConfig"]
