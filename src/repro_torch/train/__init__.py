"""Training substrate: optimizer, gradient compression, step builder
(the port of ``repro.train``)."""

from . import compress, optimizer, step  # noqa: F401
from .optimizer import AdamWConfig  # noqa: F401
from .step import (  # noqa: F401
    build_eval_step,
    build_train_step,
    init_train_state,
    load_train_tree,
    train_state_axes,
    train_tree,
)
