#!/usr/bin/env python3
"""Speed benchmark of the PyTorch/CUDA port on one NVIDIA GPU: progressive
path tracing of the 100k-triangle glass scene at 512x512, 1 spp per frame
(the workload of the JAX package's bench.py).

    python3 bench_torch.py

Prints the card's name and power limit and, as the last line, one JSON
object {"metric": "pt_progressive_fps_100k_tri_512px", "value": fps,
"unit": "fps_at_1spp", "vs_baseline": fps / 30, ...}; exits non-zero
without CUDA or when compaction cut any path.  The measurement is
`ti_raytrace_tpu_torch/tools/bench.py`.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ti_raytrace_tpu_torch.tools.bench import main

    raise SystemExit(main())
