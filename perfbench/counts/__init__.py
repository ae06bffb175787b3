"""The yardstick's frozen arithmetic: the chip's published peaks, the
operations and bytes of prefill attention, and the model FLOPs of a
prefill.  Counted from the shapes of the work, never from the program."""
