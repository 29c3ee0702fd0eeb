"""mfu.train: the train steps' least time at the card's peaks (each step's
model FLOPs, 6 a matrix parameter a token plus the attention products
forward and backward without recompute, against its necessary bytes:
weights, gradients, AdamW's state) over the untraced window, in percent."""
from benchlib.readers import mfu as read  # noqa: F401
