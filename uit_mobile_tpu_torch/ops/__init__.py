from .mel import TFB_MIN_BATCH, launches, log_mel, make_frontend_fn
from .pipeline import (make_block_builder, make_forward_fn, make_framewise_fn,
                       make_scanned_forward)

__all__ = ["TFB_MIN_BATCH", "launches", "log_mel", "make_block_builder", "make_frontend_fn",
           "make_forward_fn", "make_framewise_fn", "make_scanned_forward"]
