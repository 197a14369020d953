"""Checkpointing (the port of ``repro.checkpoint``)."""

from .store import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
