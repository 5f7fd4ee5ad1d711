"""Host-side utilities of the port."""

from .prof import Timers

__all__ = ["Timers"]
