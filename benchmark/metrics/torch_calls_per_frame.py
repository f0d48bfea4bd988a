"""torch_calls_per_frame: top-level torch calls (functions and tensor
methods) made by one traced call of the window, over its frames: the
host dispatch of the integrators and everything they call."""


def read(rec):
    return rec.torch_calls / rec.counted_frames if rec.torch_calls else None
