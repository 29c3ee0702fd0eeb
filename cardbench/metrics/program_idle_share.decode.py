"""program_idle_share.decode: of the traced window's device idle time
(the gaps between the parts of its activities' union), the share during
which the thread that launched the activity after the gap was inside the
port's span ``serve.decode_step`` (the decode bundle's entry), in
percent; the rest is the caller's (the argmax, the tokens' copy to the
host, the loop).  From the port's own ranges (``benchlib.program``), so
None for a port without them."""
from benchlib import program

SPANS = program.SPANS


def read(r):
    prog = program.of(r)
    if prog is None or prog.idle_total_s <= 0:
        return None
    return 100.0 * prog.idle_within("serve.decode_step") / prog.idle_total_s
