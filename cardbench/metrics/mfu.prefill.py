"""mfu.prefill: the prefills' least time at the card's peaks (2 FLOPs a
matrix parameter a token plus the causal attention products, against the
weights read and the cache written) over the untraced window, in
percent."""
from benchlib.readers import mfu as read  # noqa: F401
