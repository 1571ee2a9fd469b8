"""Shared utilities: device selection, tables."""

from .device import resolve_device
from .table import AsciiTable

__all__ = ["resolve_device", "AsciiTable"]
