"""ms_per_frame: the window's whole wall time over the frames completed in
it (host clock; every call ends in a device synchronize, and a call cut
by the window's end is neither timed nor counted)."""


def read(rec):
    return rec.window_s / rec.frames * 1e3 if rec.frames else None
