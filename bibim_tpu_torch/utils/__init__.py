"""Utilities of the port: capacity validation, the resource root, the
asset loaders' logging helpers, timing and profiling hooks."""
