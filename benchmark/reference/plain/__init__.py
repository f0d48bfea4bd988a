"""The port's render path frozen in plain PyTorch for the benchmark's
reference: ti_raytrace_tpu_torch's modules as they stood when the
benchmark was defined, with the imports renamed, the cluster kernel
replaced by a plain tracer that gives its bits (ops/cluster_trace.py),
every draw by the plain threefry (core/rng.py), OBJ files read by the
Python parser, and without the BVH, the dense kernel's table, the npz
cache and the PNG and checkpoint writers.  Later changes to the program
do not reach it."""
