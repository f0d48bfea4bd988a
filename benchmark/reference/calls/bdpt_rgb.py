"""bdpt_rgb as the CLI's render_batch dispatches it: every frame in 2
slices with the configuration's walk compaction and shadow cap."""

from reference.plain.integrators import bdpt_rgb


def render_call(ref, fl, n: int):
    cfg = ref.cfg
    return bdpt_rgb.render_film_frames(
        ref.scene, ref.spec, ref.cam, fl, n_frames=n, n_slices=2,
        walk_compaction=cfg.bdpt_walk_compaction, shadow_cap=cfg.bdpt_shadow_cap)
