"""Global constants and enum codes (twin of ti_raytrace_tpu/core/constants.py,
the subset the port uses).  The numeric codes match the reference
so host dicts and npz caches are interchangeable between the packages."""

import numpy as np

# --- math ---------------------------------------------------------------
PI = float(np.pi)
TWO_PI = float(2.0 * np.pi)
INF = 1.0e6  # rays miss at t >= INF
EPS = 1e-5

# --- physical constants of Planck's law -----------------------------------
BOLTZMANN_K = 1.38064852e-23
PLANCK_H = 6.62607015e-34
LIGHT_C = 299792458.0

# --- material type codes -------------------------------------------------
MAT_DISNEY = 0
MAT_GLASS = 1
MAT_LIGHT = 2
MAT_SPECTRAL = 10

# --- analytic shape type codes -------------------------------------------
SHAPE_NONE = 0
SHAPE_SPHERE = 1
SHAPE_QUAD = 2
SHAPE_SPOT = 3
SHAPE_LASER = 4

# --- primitive type codes ------------------------------------------------
PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SHAPE = 2

# --- XYZ <-> linear sRGB (the reference's matrices, rows r, g, b / x, y, z)
XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)
SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)

# --- spectral sampling ---------------------------------------------------
LAMBDA_MIN = 360.0
LAMBDA_MAX = 760.0
N_HERO = 4  # correlated hero wavelengths per spectral path
