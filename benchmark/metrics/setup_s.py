"""setup_s: process start to the end of the warm-up call: imports, the
CUDA context, the program's kernels and scene from the checkout's cache
(built there on a first run), the camera and one call of the cell's
shape (host clock)."""


def read(rec):
    return rec.setup_s
