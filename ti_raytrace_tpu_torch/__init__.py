"""PyTorch + CUDA port of the ti_raytrace_tpu renderer.

Same module layout and public names as the JAX package
(`ti_raytrace_tpu/`), which stays the reference every module here is held
against.  This package imports torch and numpy only — never jax and never
the JAX package — so it runs on a machine that has neither.

Slices ported so far: the 100k-triangle progressive path tracer
(`examples/scenes.benchmark_100k` -> `integrators/pt_rgb.
render_film_frames_merged`), and the Veach MIS scene under the path
tracer with next-event estimation (`examples/scenes.veach_bdpt` ->
`pt_rgb.render_film_frames`, exact path, `nee=True`; the golden gate
`tools/golden.py --scene veach_pt`).  The cluster traversal is a
hand-written CUDA kernel (`csrc/cluster_trace.cu`, wrapped by
`ops/cluster_trace.py`).  Everything outside the slices raises
NotImplementedError naming its ROADMAP item.
"""
