"""Utilities of the port: capacity validation, the resource root and the
asset loaders' logging helpers."""
