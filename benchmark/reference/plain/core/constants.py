"""Global constants and enum codes (twin of ti_raytrace_tpu/core/constants.py,
the subset the port uses).  The numeric codes match the reference
so host dicts and npz caches are interchangeable between the packages."""

import numpy as np

# --- math ---------------------------------------------------------------
PI = float(np.pi)
TWO_PI = float(2.0 * np.pi)
INF = 1.0e6  # rays miss at t >= INF
EPS = 1e-5


# --- material type codes -------------------------------------------------
MAT_DISNEY = 0
MAT_GLASS = 1
MAT_LIGHT = 2
MAT_SPECTRAL = 10

SHAPE_SPHERE = 1
SHAPE_SPOT = 3
SHAPE_LASER = 4

PRIM_TRI = 1
PRIM_SHAPE = 2

