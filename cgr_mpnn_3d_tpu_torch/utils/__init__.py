"""Shared utilities: device selection, tables, JSON results files."""

from .device import resolve_device
from .json_io import json_dumper, load_results
from .table import AsciiTable

__all__ = ["resolve_device", "json_dumper", "load_results", "AsciiTable"]
