"""PyTorch + CUDA port of the ti_raytrace_tpu renderer.

Same module layout and public names as the JAX package
(`ti_raytrace_tpu/`), which stays the reference every module here is held
against.  This package imports torch and numpy only — never jax and never
the JAX package — so it runs on a machine that has neither.

Ported so far: the 100k-triangle progressive path tracer
(`examples/scenes.benchmark_100k` -> `integrators/pt_rgb.
render_film_frames_merged`); the Veach MIS scene under the path tracer
with next-event estimation (`pt_rgb.render_film_frames`, `nee=True`) and
under bidirectional path tracing (`integrators/bdpt_rgb`); and the four
path-traced scenes of the dense tracer (`ops/dense_trace.py`):
cornell_box and single_model under `pt_rgb`, sky_dome and spectral_box
under the hero-wavelength spectral path tracer (`integrators/pt_spec`),
with the debug AOVs (`integrators/debug`) and the golden gates
(`tools/golden.py`).  The cluster traversal is a hand-written CUDA
kernel (`csrc/cluster_trace.cu`, wrapped by `ops/cluster_trace.py`); the
dense sweep is plain torch ops.  Everything outside the ported slices
raises NotImplementedError naming its ROADMAP item.
"""
