"""idle_share.decode: the share of the untraced window in which no kernel,
copy or set ran on the card, in percent (``benchlib.readers.idle_share``:
busy time from the traced window, scaled by the two windows' work)."""
from benchlib.readers import idle_share as read  # noqa: F401
