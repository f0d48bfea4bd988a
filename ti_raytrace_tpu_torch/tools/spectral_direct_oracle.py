"""First-principles direct-lighting oracle for the spectral cornell box
(twin of ti_raytrace_tpu/tools/spectral_direct_oracle.py):

    python -m ti_raytrace_tpu_torch.tools.spectral_direct_oracle \
        [--image OURS.png] [--device cuda]

Computes with plain numpy quadrature (no renderer on either side) the
expected display value of a directly-lit wall patch: the lamp quad's
emission E(lam) = ||Ke||_2 * D65_norm(lam), the measured-SPD reflectance,
the Disney diffuse lobe, the hero-sampling CIE splat (its span / 4
factor) and the ACES(0.5) + sRGB display transform; then samples the same
patch pixels, found through the port's `camera.project` of the
spectral_box camera, from the reference golden and, with --image, from a
render of ours.  Direct light only: the oracle is a lower bound on
patches where one bounce dominates.
"""

import argparse
import sys

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def schlick(u):
    m = np.clip(1.0 - u, 0.0, 1.0)
    return m ** 5


def disney_diffuse_eval(n, v, l, roughness):
    """The diffuse lobe's scalar with metal 0: (Fsheen + 1/pi) * Fd,
    Csheen = 0.5."""
    ndl = float(np.dot(n, l))
    ndv = float(np.dot(n, v))
    if ndl <= 0.0 or ndv <= 0.0:
        return 0.0
    h = (l + v) / np.linalg.norm(l + v)
    ldh = float(np.dot(l, h))
    fl, fv, fh = schlick(ndl), schlick(ndv), schlick(ldh)
    fd90 = 0.5 + 2.0 * ldh * ldh * roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    return (fh * 0.5 + 1.0 / np.pi) * fd


def lamp_quad_and_patches():
    """(mesh, lamp triangles (T, 3, 3), the lamp's material index) of
    cornell_box.obj."""
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.io.obj import load_obj

    mesh = load_obj(asset_path("model/cornell_box.obj"))
    light_id = next(i for i, m in enumerate(mesh.materials) if max(m.emissive) > 0.0)
    return mesh, np.asarray(mesh.tri_pos[light_id]), light_id


def _occluded(p, q, tris):
    """Does any of tris (T, 3, 3) block the segment p -> q
    (Moller-Trumbore)?"""
    d = q - p
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    pv = np.cross(d[None, :], e2)
    det = (e1 * pv).sum(1)
    ok = np.abs(det) > 1e-12
    inv = 1.0 / np.where(ok, det, 1.0)
    tv = p[None, :] - v0
    u = (tv * pv).sum(1) * inv
    qv = np.cross(tv, e1)
    v = (d[None, :] * qv).sum(1) * inv
    t = (e2 * qv).sum(1) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < 1.0 - 1e-4)
    return bool(hit.any())


def integrate_direct(p, n, cam_pos, lamp_tris, emission_scale, occ_tris, rough=0.5, grid=24):
    """Direct transport factor at the patch point p: the
    wavelength-independent sum over lamp samples of brdf(cam, wl) cos_s
    cos_l / r^2 dA, with occlusion against occ_tris, times
    emission_scale (the emission spectrum multiplies outside)."""
    v = cam_pos - p
    v = v / np.linalg.norm(v)
    total = 0.0
    occluded_n = samples_n = 0
    for a, b, c in lamp_tris:
        area = 0.5 * np.linalg.norm(np.cross(b - a, c - a))
        ln = np.cross(b - a, c - a)
        ln = ln / np.linalg.norm(ln)
        us = (np.arange(grid) + 0.5) / grid
        for u1 in us:
            for u2 in us:
                uu, vv = (u1, u2) if u1 + u2 <= 1.0 else (1 - u1, 1 - u2)
                q = a + (b - a) * uu + (c - a) * vv
                d = q - p
                r2 = float(np.dot(d, d))
                wl = d / np.sqrt(r2)
                cos_s = float(np.dot(n, wl))
                cos_l = abs(float(np.dot(ln, wl)))
                if cos_s <= 0.0:
                    continue
                samples_n += 1
                if _occluded(p, q, occ_tris):
                    occluded_n += 1
                    continue
                brdf = disney_diffuse_eval(n, v, wl, rough)
                total += brdf * cos_s * cos_l / r2 * (2.0 * area / grid / grid)
    log(f"  occluded {occluded_n}/{samples_n} lamp samples")
    return total * emission_scale


def display_value(l_scalar, refl_spd, sensor, d65n):
    """Hero-sampled CIE splat of L(lam) = l_scalar * refl(lam) *
    D65n(lam), averaged over the lambda0 distribution -> (display sRGB,
    linear sRGB)."""
    from ti_raytrace_tpu_torch.core import constants as C
    from ti_raytrace_tpu_torch.utils.colorsp import lrgb_to_srgb, tone_aces

    span = sensor.lambda_max - sensor.lambda_min
    lam0 = np.linspace(360.0, 460.0, 256, endpoint=False)
    lam4 = lam0[:, None] + np.arange(4)[None, :] * 100.0  # (256, 4)
    L = l_scalar * refl_spd.sample(lam4) * d65n.sample(lam4)
    xyz_bar = sensor.sample(lam4.reshape(-1)).reshape(256, 4, 3)
    xyz = ((xyz_bar * L[..., None]).sum(axis=1) * (span / 4.0)).mean(axis=0)
    lrgb = np.asarray(C.XYZ_TO_SRGB) @ xyz
    disp = lrgb_to_srgb(tone_aces(torch.as_tensor(np.maximum(lrgb, 0.0) * 0.5)))
    return np.clip(disp.numpy(), 0, 1), lrgb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image", default=None, help="our rendered PNG (e.g. spectral_box.png)")
    ap.add_argument("--rough", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="where the scene's camera is built")
    args = ap.parse_args(argv)

    from ti_raytrace_tpu_torch.camera import project
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.io.image import read_image
    from ti_raytrace_tpu_torch.spectral.cie import load_cie_sensor, load_d65, white_point
    from ti_raytrace_tpu_torch.spectral.spd import Spd, load_spd_csv
    from ti_raytrace_tpu_torch.tools.golden import load_reference

    sensor = load_cie_sensor()
    d65 = load_d65()
    d65n = Spd(d65.lambdas, d65.values / white_point(sensor, d65)[1])
    white = load_spd_csv(asset_path("spectrum/white-spec.csv"))

    mesh, lamp, light_id = lamp_quad_and_patches()
    occ = np.concatenate([np.asarray(t) for i, t in enumerate(mesh.tri_pos)
                          if len(t) and i != light_id], axis=0)
    allv = occ.reshape(-1, 3)
    lo, hi = allv.min(axis=0), allv.max(axis=0)
    centre = 0.5 * (lo + hi)

    scene, cfg = EXAMPLES["spectral_box"](args.device)
    spec, cam = make_camera(scene, cfg, 512, 512)
    cam_pos = cam.eye.cpu().numpy().astype(np.float64)
    emission_scale = float(np.linalg.norm([10.0, 10.0, 10.0]))

    # probes on the back wall (white measured SPD, facing +z toward the
    # camera): upper (above the boxes, unshadowed) and mid-height
    back_z = lo[2]
    probes = [
        ("back-wall-upper", np.asarray([centre[0], lo[1] + 0.75 * (hi[1] - lo[1]),
                                        back_z + 1e-3]), np.asarray([0.0, 0.0, 1.0])),
        ("back-wall-mid", np.asarray([centre[0] * 0.8, lo[1] + 0.45 * (hi[1] - lo[1]),
                                      back_z + 1e-3]), np.asarray([0.0, 0.0, 1.0])),
    ]
    ref = load_reference("image/spectral-cornellbox.png")[..., :3]
    ours = read_image(args.image)[..., :3] if args.image else None
    for name, p, n in probes:
        tf = integrate_direct(p, n, cam_pos, lamp, emission_scale, occ, args.rough)
        disp = display_value(tf, white, sensor, d65n)
        u, v, _, valid = project(spec, cam, torch.as_tensor(p, dtype=torch.float32,
                                                            device=cam.eye.device))
        px, py = int(u), int(v)
        row = 512 - 1 - py  # film (x, y) with y up -> image row
        print(f"{name}: pixel (x={px}, row={row}, valid={bool(valid)}) transport {tf:.5f}")
        print(f"  oracle direct-only sRGB: {disp}")
        patch = ref[max(row - 6, 0):row + 6, max(px - 6, 0):px + 6]
        print(f"  golden patch mean rgb:   {patch.mean(axis=(0, 1))}")
        if ours is not None:
            op = ours[max(row - 6, 0):row + 6, max(px - 6, 0):px + 6]
            print(f"  ours   patch mean rgb:   {op.mean(axis=(0, 1))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
