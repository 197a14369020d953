"""Data pipeline (the port of ``repro.data``)."""

from .pipeline import SyntheticTokens, make_batch_specs  # noqa: F401
