"""bdpt_spec as the CLI's render_batch dispatches it: every frame unsliced,
with the configuration's emitter scale, walk compaction and shadow cap."""

from reference.plain.integrators import bdpt_spec


def render_call(ref, fl, n: int):
    cfg = ref.cfg
    render_frame = bdpt_spec.make_render_frame(
        **cfg.sky, walk_compaction=cfg.bdpt_walk_compaction, shadow_cap=cfg.bdpt_shadow_cap,
        device=ref.scene.device)
    return bdpt_spec.render_film_frames(ref.scene, ref.spec, ref.cam, fl, render_frame,
                                        n_frames=n)
