"""Procedural densification of a triangle soup (twin of
ti_raytrace_tpu/io/meshgen.py): the 100k-triangle benchmark mesh is a
subdivided Teapot."""

import numpy as np


def _stack(c0, c1, c2):
    return np.stack([c0, c1, c2], axis=1)


def subdivide4(pos, nrm, uv):
    """1:4 midpoint subdivision.  pos/nrm: (T,3,3); uv: (T,3,2)."""
    def mids(a):
        a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
        return 0.5 * (a0 + a1), 0.5 * (a1 + a2), 0.5 * (a2 + a0)

    def split(a):
        a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
        m01, m12, m20 = mids(a)
        return np.concatenate([_stack(a0, m01, m20), _stack(m01, a1, m12),
                               _stack(m20, m12, a2), _stack(m01, m12, m20)])

    return (split(pos).astype(np.float32), split(nrm).astype(np.float32),
            split(uv).astype(np.float32))


def split2(pos, nrm, uv):
    """1:2 split along edge v0-v1 (uniform; doubles the count)."""
    def split(a):
        m = 0.5 * (a[:, 0] + a[:, 1])
        return np.concatenate([_stack(a[:, 0], m, a[:, 2]),
                               _stack(m, a[:, 1], a[:, 2])])

    return (split(pos).astype(np.float32), split(nrm).astype(np.float32),
            split(uv).astype(np.float32))


def densify_to(pos, nrm, uv, target: int):
    """Subdivide until at least `target` triangles (1:4 steps, then one
    1:2 step if that overshoots less)."""
    while pos.shape[0] < target:
        if pos.shape[0] * 2 >= target:
            pos, nrm, uv = split2(pos, nrm, uv)
        else:
            pos, nrm, uv = subdivide4(pos, nrm, uv)
    return pos, nrm, uv
