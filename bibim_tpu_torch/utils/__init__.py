"""Utilities of the port (capacity validation)."""
