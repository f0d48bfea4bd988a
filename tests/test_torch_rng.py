"""The port's threefry2x32 key chain (ti_raytrace_tpu_torch/core/rng.py)
against jax.random: keys and uniforms must be BIT-equal, which is what
makes whole renders of the two packages comparable pixel by pixel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.core import rng

torch.set_num_threads(2)


def _jkey(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 13, 2**31 + 5, 2**32 - 1])
def test_prng_key_split_fold_in_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _jkey(jk))
    for num in (2, 3):
        np.testing.assert_array_equal(rng.split(tk, num).numpy(),
                                      _jkey(jax.random.split(jk, num)))
    for data in (0, 1, 14, 2**31 + 3):
        np.testing.assert_array_equal(rng.fold_in(tk, data).numpy(),
                                      _jkey(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", [(2, 256), (8, 1000), (8, 513), (3,)])
def test_uniform_bit_equal(shape):
    jk = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(5))[1], 3)
    tk = rng.fold_in(rng.split(rng.PRNGKey(5))[1], 3)
    ju = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
    tu = rng.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32 and tu.shape == ju.shape
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))
    assert (tu >= 0.0).all() and (tu < 1.0).all()


def test_render_key_chain_bit_equal():
    """Every draw of the merged render path: film key -> split ->
    (camera key, path key), fold_in(path key, bounce), the merged key
    split(key0)[1], and the film's per-frame split chain."""
    jk, tk = jax.random.PRNGKey(3), rng.PRNGKey(3)
    for frame in range(4):
        j_cam, j_path = jax.random.split(jk)
        t_cam, t_path = rng.split(tk)
        np.testing.assert_array_equal(
            rng.uniform(t_cam, (2, 300)).numpy(),
            np.asarray(jax.random.uniform(j_cam, (2, 300), dtype=jnp.float32)))
        for depth in (0, 1, 9):
            np.testing.assert_array_equal(
                rng.uniform(rng.fold_in(t_path, depth), (8, 200)).numpy(),
                np.asarray(jax.random.uniform(jax.random.fold_in(j_path, depth),
                                              (8, 200), dtype=jnp.float32)))
        np.testing.assert_array_equal(rng.split(tk)[1].numpy(),
                                      _jkey(jax.random.split(jk)[1]))
        jk, _ = jax.random.split(jk)
        tk = rng.split(tk)[0]
        np.testing.assert_array_equal(tk.numpy(), _jkey(jk))


def test_film_key_chain_matches_reference():
    """accumulate / accumulate_group advance the film key exactly like the
    reference film, so checkpoints stay interchangeable."""
    from ti_raytrace_tpu import film as jfilm
    from ti_raytrace_tpu_torch import film as tfilm

    jf, tf = jfilm.new_film(4, 4, seed=11), tfilm.new_film(4, 4, seed=11, device="cpu")
    img = np.random.default_rng(0).random((4, 4, 3), np.float32)
    jf = jfilm.accumulate_group(jfilm.accumulate(jf, jnp.asarray(img)), jnp.asarray(img), 3)
    tf = tfilm.accumulate_group(tfilm.accumulate(tf, torch.from_numpy(img)),
                                torch.from_numpy(img), 3)
    assert tf.frame == int(jf.frame) == 4
    np.testing.assert_array_equal(tf.key.numpy(), _jkey(jf.key))
    np.testing.assert_allclose(tf.hdr.numpy(), np.asarray(jf.hdr), rtol=1e-6)
