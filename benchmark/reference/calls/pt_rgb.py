"""pt_rgb as the CLI's render_batch dispatches it: merged groups where the
configuration has a schedule and n is a whole number of groups, else
frame after frame; NEE where the scene has a material that takes it."""

from reference.plain.integrators import pt_rgb


def render_call(ref, fl, n: int):
    cfg, scene = ref.cfg, ref.scene
    nee = pt_rgb.has_nee_materials(scene)
    group = cfg.group or 0
    if cfg.compaction and group > 1 and n % group == 0:
        return pt_rgb.render_film_frames_merged(
            scene, ref.spec, ref.cam, fl, n_frames=n, group=group, compaction=cfg.compaction,
            nee=nee, pay_divisors=cfg.pay_divisors)
    return pt_rgb.render_film_frames(scene, ref.spec, ref.cam, fl, n_frames=n,
                                     compaction=cfg.compaction, nee=nee)
