"""The port's multi-device layer (ti_raytrace_tpu_torch/parallel/) on the
CPU: the per-shard bodies against the JAX package's, and 2-rank gloo runs
of the five sharded paths (parallel/dryrun.py, spawned once for the
module) against the port's own per-shard mirror.

Tolerances, with their reasons:
  * per-shard bodies against JAX: >= 98% of pixels within rtol 1e-3 and
    means within 1%, the render bar of test_torch_pt_rgb.py (XLA fuses
    multiply-adds on the CPU, the port does not; an ulp flips a discrete
    decision now and then and with it a whole path); film key and frame
    count bit-equal (core/rng is bit-equal);
  * 2-rank runs against the per-shard mirror, and 2-rank BDPT against
    render_frame_sliced(n_slices=2): bit for bit (same keys, same lanes;
    the gather adds zeros and two splat films add in either order alike);
  * lane_film_image: exact (a permutation).
The spawning fixture has its own time limit: the ranks' join timeout,
which is also their rendezvous and collective timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_trace import cameras, reference_and_port
from ti_raytrace_tpu.parallel import shard as jshard
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.parallel import dryrun
from ti_raytrace_tpu_torch.parallel import shard as tshard

torch.set_num_threads(2)

SIZE = 32
KF = 2
GROUP = 2
COMPACTION = ((1, 2),)
N_SHARDS = 2
DRYRUN_SIZE = 16
DRYRUN_TIMEOUT = 240.0


def _assert_render_close(a, b):
    assert a.shape == b.shape and np.isfinite(a).all()
    assert b.mean() > 0.0
    assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=0).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()


@pytest.mark.parametrize("shard_idx", range(N_SHARDS))
def test_merged_lane_shard_matches_reference(shard_idx):
    """One shard of the merged production path on the shard's pixels
    (`film_lanes`' interleaved morton blocks, given to both): cornell_box
    at 32^2, 2 frames in a merged group of 2, schedule ((1, 2),), NEE."""
    js, _, _, ts, _, _ = reference_and_port("cornell_box")
    (jspec, jcam), (tspec, tcam) = cameras("cornell_box", SIZE)
    ns = SIZE * SIZE // N_SHARDS
    tpx, tpy = tshard.shard_pixels(tspec, tshard.Mesh(shard_idx, N_SHARDS,
                                                      torch.device("cpu")))
    want = jax.jit(lambda s, c, px_, py_: jshard._merged_lane_shard(
        s, jspec, c, jnp.zeros((3, ns), jnp.float32), jnp.int32(0),
        jax.random.PRNGKey(3), shard_idx, px_, py_, KF, GROUP, COMPACTION, True))(
            js, jcam, jnp.asarray(tpx.numpy()), jnp.asarray(tpy.numpy()))
    hdr, frame, key, ov = tshard._merged_lane_shard(
        ts, tspec, tcam, torch.zeros(3, ns), 0, rng.PRNGKey(3), shard_idx, tpx, tpy, KF,
        GROUP, COMPACTION, True)
    assert frame == int(want[1]) == KF
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jax.random.key_data(want[2])).astype(np.int64))
    assert int(ov) == int(want[3]) == 0
    _assert_render_close(hdr.numpy(), np.asarray(want[0]))


@pytest.fixture(scope="module")
def bdpt_reference():
    """The reference's per-shard BDPT body, as tests/test_render.py
    mirrors it, on cornell_box at 32^2, max_depth 1, jitted once."""
    from ti_raytrace_tpu.camera import ray_directions, ray_origins
    from ti_raytrace_tpu.integrators import bdpt_rgb as jbd

    js, _, _, _, _, _ = reference_and_port("cornell_box")
    (jspec, jcam), _ = cameras("cornell_box", SIZE)
    key = jax.random.PRNGKey(5)
    k_cam, k_eye, k_light, k_conn = jax.random.split(key, 4)
    o = jnp.swapaxes(ray_origins(jspec, jcam), 0, 1)
    d = jnp.swapaxes(ray_directions(jspec, jcam, jnp.int32(1), k_cam), 0, 1)
    ns = SIZE * SIZE // N_SHARDS

    @jax.jit
    def one_shard(o_sl, d_sl, i):
        eye, eye_count = jbd.build_eye_path_rays(js, o_sl, d_sl, jax.random.fold_in(k_eye, i),
                                                 eye_depth=3)
        light, light_count = jbd.build_light_path(js, ns, jax.random.fold_in(k_light, i),
                                                  light_depth=2)
        return jbd._connections(js, jspec, jcam, eye, eye_count, light, light_count,
                                jax.random.fold_in(k_conn, i), max_depth=1)

    return {i: [np.asarray(x) for x in one_shard(o[:, i * ns:(i + 1) * ns],
                                                 d[:, i * ns:(i + 1) * ns], jnp.int32(i))]
            for i in range(N_SHARDS)}


@pytest.mark.parametrize("shard_idx", range(N_SHARDS))
def test_bdpt_shard_matches_reference(bdpt_reference, shard_idx):
    """The port's per-shard BDPT body (separate eye and light walks, every
    connection, the shard's splat film) against the reference's on the
    same keys: radiance by the render bar, the splat film's sum within 1%."""
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb as tbd

    _, _, _, ts, _, _ = reference_and_port("cornell_box")
    _, (tspec, tcam) = cameras("cornell_box", SIZE)
    keys = rng.split(rng.PRNGKey(5), 4)
    o, d = tbd._camera_rays(tspec, tcam, 1, keys[0])
    sl = tshard._lanes(SIZE * SIZE, tshard.Mesh(shard_idx, N_SHARDS, torch.device("cpu")))
    rad, splat, ov = tshard._bdpt_shard(ts, tspec, tcam, o[:, sl], d[:, sl], keys[1:],
                                        shard_idx, 1)
    want_rad, want_splat = bdpt_reference[shard_idx]
    assert int(ov) == 0 and splat.shape == want_splat.shape == (SIZE, SIZE, 3)
    _assert_render_close(rad.numpy(), want_rad)
    assert want_splat.sum() > 0.0
    assert abs(float(splat.sum()) - want_splat.sum()) <= 0.01 * want_splat.sum()


@pytest.fixture(scope="module")
def dryrun_cpu():
    """The five sections on 2 spawned gloo ranks at 16^2, each held to the
    per-shard mirror by dryrun_multichip itself."""
    return dryrun.dryrun_multichip(N_SHARDS, device="cpu", size=DRYRUN_SIZE, frames=1,
                                   timeout=DRYRUN_TIMEOUT)


@pytest.mark.parametrize("section", dryrun.SECTIONS)
def test_two_ranks_equal_the_mirror(dryrun_cpu, section):
    r = dryrun_cpu[section]
    assert r["img"].shape == (DRYRUN_SIZE, DRYRUN_SIZE, 3)
    assert np.isfinite(r["img"]).all() and r["img"].mean() > 0.0
    assert r["backend"] == "gloo" and r["overflow"] == 0
    assert r["launches"] == [0] * N_SHARDS  # CPU tensors take the plain version
    assert len(r["seconds"]) == N_SHARDS and r["mirror_seconds"] > 0.0


def test_dryrun_reports_the_ranks_start(dryrun_cpu):
    assert len(dryrun_cpu["start_s"]) == len(dryrun_cpu["all_reduce_ms"]) == N_SHARDS
    assert all(0.0 < s < DRYRUN_TIMEOUT for s in dryrun_cpu["start_s"])
    assert all(0.0 < t < DRYRUN_TIMEOUT * 1e3 for t in dryrun_cpu["all_reduce_ms"])
    assert set(dryrun_cpu) == set(dryrun.SECTIONS) | {"start_s", "all_reduce_ms"}


def test_two_rank_bdpt_equals_sliced_frame(dryrun_cpu):
    """The 2-rank Veach BDPT frame is the production 2-slice frame, bit
    for bit: the ranks walk eye and light subpaths separately, the sliced
    frame fuses each depth's two traces, and a lane's hit does not depend
    on its wavefront."""
    from ti_raytrace_tpu_torch.examples.scenes import example_cached, make_camera
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    scene, cfg = example_cached("veach_bdpt", "cpu")
    spec, cam = make_camera(scene, cfg, DRYRUN_SIZE, DRYRUN_SIZE)
    img, ov = bdpt_rgb.render_frame_sliced(scene, spec, cam, 1, rng.PRNGKey(dryrun.SEED),
                                           n_slices=N_SHARDS, return_overflow=True)
    assert int(ov) == dryrun_cpu["bdpt"]["overflow"] == 0
    np.testing.assert_array_equal(dryrun_cpu["bdpt"]["img"], img.numpy())


def test_film_lanes_interleave_whole_tiles():
    """The merged path's lanes: a partition of the film into blocks of 256
    lanes (of 128 where a rank holds fewer), dealt round-robin."""
    for n, size, blk in ((512 * 512, 2, 256), (16 * 16, 2, 128), (32 * 32, 4, 256)):
        lanes = [tshard.film_lanes(n, tshard.Mesh(r, size, torch.device("cpu")))
                 for r in range(size)]
        assert sorted(np.concatenate(lanes).tolist()) == list(range(n))
        for r, ln in enumerate(lanes):
            assert ln.size == n // size and (ln.reshape(-1, blk)[:, 0] // blk % size == r).all()


def test_lane_film_image_unpermute_and_reference():
    """lane_film_image inverts the morton lane order exactly, and equals
    the reference's on the same lanes."""
    from ti_raytrace_tpu.camera import morton_pixel_order
    from ti_raytrace_tpu_torch.camera import CameraSpec

    spec = CameraSpec(SIZE, SIZE)
    N = SIZE * SIZE
    perm, _ = morton_pixel_order(SIZE, SIZE)
    hdr = torch.as_tensor(np.broadcast_to(perm[None, :].astype(np.float32), (3, N)).copy())
    img = tshard.lane_film_image(tshard.LaneFilm(hdr, 1, rng.PRNGKey(0)), spec).numpy()
    np.testing.assert_array_equal(img[..., 0],
                                  np.arange(N, dtype=np.float32).reshape(SIZE, SIZE))
    lanes = np.random.default_rng(11).random((3, N), dtype=np.float32)
    want = jshard.lane_film_image(
        jshard.LaneFilm(hdr=jnp.asarray(lanes), frame=jnp.int32(1),
                        key=jax.random.PRNGKey(0)), spec)
    got = tshard.lane_film_image(tshard.LaneFilm(torch.from_numpy(lanes), 1, None), spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_mesh_needs_a_process_group():
    """No process group, no mesh: never a quiet 1-rank fallback; and a
    rank asked for CUDA where there is none does not carry on."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tshard.make_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA, which is not available"):
            tshard.init_mesh(0, 1, "/nonexistent/store", device="cuda")
        with pytest.raises(RuntimeError, match="not available"):
            dryrun.dryrun_multichip(1, device="cuda")
