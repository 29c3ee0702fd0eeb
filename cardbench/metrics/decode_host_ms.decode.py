"""decode_host_ms.decode: the host milliseconds of a decode step from the
call into the decode bundle's ``serve_step`` to its return (its tokens
not yet on the host), the mean over the untraced window's steps."""


def read(r):
    if not r.host_call_s:
        return None
    return 1e3 * sum(r.host_call_s) / len(r.host_call_s)
