"""mfu.decode: the decode steps' least time at the card's peaks (their
bytes bind: the weights read once a step and each row's cache read to its
position) over the untraced window, in percent."""
from benchlib.readers import mfu as read  # noqa: F401
