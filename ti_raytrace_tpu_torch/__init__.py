"""PyTorch + CUDA port of the ti_raytrace_tpu renderer.

Same module layout and public names as the JAX package
(`ti_raytrace_tpu/`), which stays the reference every module here is held
against.  This package imports torch and numpy only — never jax and never
the JAX package — so it runs on a machine that has neither.

Every scene of the reference renders with every integrator it has: the
100k-triangle progressive path tracer
(`examples/scenes.benchmark_100k` -> `integrators/pt_rgb.
render_film_frames_merged`); the Veach MIS scene under the path tracer
with next-event estimation (`pt_rgb.render_film_frames`, `nee=True`) and
under bidirectional path tracing (`integrators/bdpt_rgb`); and the four
path-traced scenes of the dense tracer (`ops/dense_trace.py`):
cornell_box and single_model under `pt_rgb`, sky_dome and spectral_box
under the hero-wavelength spectral path tracer (`integrators/pt_spec`);
and prism_rainbow under spectral BDPT (`integrators/bdpt_spec`), with the
debug AOVs (`integrators/debug`), the golden gates (`tools/golden.py`),
the BDPT strategy decomposition (`tools/bdpt_decompose.py`) and the speed
benchmark (`tools/bench.py`, run by `bench_torch.py`).  Both tracers
run on the card as hand-written CUDA kernels, each with a plain PyTorch
twin that CPU tensors take: the cluster traversal
(`csrc/cluster_trace.cu`, wrapped by `ops/cluster_trace.py`) and the
dense sweep (`csrc/dense_trace.cu`, wrapped by `ops/dense_trace.py`).
"""
