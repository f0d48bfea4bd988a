"""The benchmark's tests import its harness and reference as the run does
(benchmark/ first on the path, then the checkout's root for the program)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH), BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
