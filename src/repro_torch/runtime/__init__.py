"""Train and serve step construction."""

from repro_torch.runtime.steps import (
    make_decode_step,
    make_encode_step,
    make_prefill_step,
    make_train_step,
    step_fn_for,
)

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "make_encode_step", "step_fn_for"]
