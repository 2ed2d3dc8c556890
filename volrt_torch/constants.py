"""Framework-wide constants.

Copies of the values in ``volrt/constants.py``. They are copied, not
imported: importing anything under ``volrt`` loads jax
(``volrt/__init__.py`` imports ``volrt.core.types``), and the port runs
where jax is not installed. ``tests/test_torch_core.py`` holds the two
files to the same values.
"""

# 1D transfer-function LUT resolution (reference: RaycasterBase.h:15).
TF_SIZE = 128
# Ratio between the 256 possible uint8 sample values and TF_SIZE buckets
# (reference: RaycasterBase.h:16).
TF_RATIO = 256 // TF_SIZE

# Empty-space-leaping min/max block grid is ESL_VOLUME_DIMS^3 blocks
# (reference: RaycasterBase.h:12-14).
ESL_VOLUME_DIMS = 32
ESL_MIN_BLOCK_SIZE = 8

# Number of renderer rungs in the ladder (reference: common.h:16).
RENDERER_COUNT = 6  # reference ladder (5) + pallas-v3

# Default render parameters (reference: RaycasterBase.cpp:9-20).
DEFAULT_RAY_STEP = 0.06
DEFAULT_RAY_THRESHOLD = 0.95
DEFAULT_LIGHT_KD = 0.6

# Default interactive viewport (reference: ViewBase.h:11-12).
DEFAULT_WIN_WIDTH = 799
DEFAULT_WIN_HEIGHT = 715

# Shading gates (reference: CPURenderer.cpp:32, RaycasterBase.h:90).
SHADE_ALPHA_GATE = 0.05
SHADE_KD_GATE = 0.01
# Offset of the secondary shading tap toward the light
# (reference: RaycasterBase.h:91, GPURenderer4.cu:44-46).
SHADE_LIGHT_OFFSET = 0.01

# Gradient-Phong shading: ambient and specular weights and the exponent of
# the Blinn-Phong model over central-difference normals.
PHONG_KA = 0.3
PHONG_KS = 0.2
PHONG_SHININESS = 16.0
