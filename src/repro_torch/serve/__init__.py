"""Serving substrate."""

from .engine import Engine, Request  # noqa: F401
