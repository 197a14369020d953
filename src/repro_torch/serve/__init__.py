"""Serving substrate."""

from .engine import Engine, FramedLM, Request  # noqa: F401
