"""The benchmark's harness: what a run of a cell does, and the yardstick
(the window's statistics, the trace's reduction, the frozen work count
and the comparison with the plain reference).  It reads the program,
ti_raytrace_tpu_torch, only through `program.py`."""
