"""The port's ``parallel/`` (``torch.distributed``) against the JAX
package's, on the CPU, with two-rank gloo worlds spawned from the test
(tests/_torch_parallel_workers.py):

* the mesh: JAX's ``test_mesh_shapes`` cases through explicit rank
  lists, the grid in JAX's device order, JAX's error messages, and a
  rank's shard of a batch equal to JAX's shard on that device;
* on a (1, 2) mesh (one world): ``halo_exchange_d`` equal to JAX's
  under ``shard_map`` in both boundary modes, halo 1 and 2, and
  ``sharded_conv3d`` / ``zero_boundary_halo_conv`` equal to the global
  zero-pad SAME conv on each slab (first and last D planes included),
  within 1e-5 of its scale;
* inference on a (2, 1) mesh (one world, f32, tiny U-Nets):
  ``segment_cohort`` / ``segment_cohort_whole`` on N = 5 (the padding
  path) equal to JAX's on one device (labels exact, confidence within
  1e-5); ``sliding_window_inference_mp`` within ``atol 1e-4, rtol
  1e-3`` of JAX's ``sliding_window_inference`` (JAX's own bound), once
  plain and once through the ps2d region (``ps2d_eval, ps2d_levels=2``,
  the port's plain kernel versions; its level-1 pool counted). JAX's side
  of the ps2d case is its normal path given K1's weights rounded to bf16,
  the function the region computes in f32 (``UNet3D.k1_kernel_names``),
  so that JAX's Pallas kernels need not run in interpret mode.

The CLIs and the trainer are in tests/test_torch_parallel_cli.py, the
train steps in tests/test_torch_parallel_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from _torch_parallel_workers import run_world
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import (
    parallel as JP)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.sliding_window import (
    sliding_window_inference as j_sliding_window_inference)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.parallel.spatial import (
    halo_exchange_d as j_halo_exchange_d)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
    mesh as M)


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jvars(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------- mesh

@pytest.mark.parametrize("data,space", [(4, 2), (-1, 2), (2, 1), (-1, 1),
                                        (1, 8)])
def test_mesh_shapes_as_jax(data, space):
    ranks = list(range(8))
    got = M.create_mesh(data, space, devices=ranks)
    want = JP.create_mesh(data, space)
    assert got.shape == dict(want.shape)
    assert got.devices.size == want.devices.size
    np.testing.assert_array_equal(
        got.devices, np.vectorize(lambda d: d.id)(want.devices))
    assert got.coords == (0, 0) and got.groups == {}   # no process group


@pytest.mark.parametrize("data,space", [(16, 1), (-1, 3), (3, 3)])
def test_mesh_errors_as_jax(data, space):
    with pytest.raises(ValueError) as jerr:
        JP.create_mesh(data, space)
    with pytest.raises(ValueError) as terr:
        M.create_mesh(data, space, devices=list(range(8)))
    assert str(terr.value) == str(jerr.value)


def test_mesh_from_config_and_one_process():
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
        MeshConfig)
    m = M.mesh_from_config(MeshConfig(data=2, space=2),
                           devices=[0, 1, 2, 3])
    assert m.shape == {"data": 2, "space": 2}
    one = M.create_mesh()                 # no process group: one process
    assert one.shape == {"data": 1, "space": 1} and one.devices.size == 1
    x = torch.arange(6.0)
    assert M.all_reduce_(x.clone(), one.group("data")).equal(x)
    assert M.mean_over([x], None)[0] is x
    assert M.initialize_distributed(device="cpu") == torch.device("cpu")


@pytest.mark.parametrize("rank", [0, 3, 5])
def test_shard_batch_is_jaxs_shard_on_that_device(rank):
    rng = np.random.default_rng(rank)
    x = rng.normal(size=(8, 8, 4, 4, 2)).astype(np.float32)
    jm = JP.create_mesh(4, 2)
    shards = {s.device.id: np.asarray(s.data) for s in
              JP.shard_batch({"image": jnp.asarray(x)}, jm)["image"]
              .addressable_shards}
    tm = M.Mesh(np.arange(8).reshape(4, 2), rank=rank)
    got = M.shard_batch({"image": x}, tm)["image"]
    np.testing.assert_array_equal(got, shards[rank])
    # the data axis alone: rows only
    dm = M.Mesh(np.arange(4).reshape(4, 1), rank=rank % 4)
    np.testing.assert_array_equal(M.shard_batch(x, dm),
                                  x[2 * (rank % 4):2 * (rank % 4) + 2])
    with pytest.raises(ValueError):
        M.shard_batch(x[:3], dm)


# ---------------------------------------------------------------- spatial

@pytest.fixture(scope="module")
def spatial_world(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 6, 5, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 3, 4)).astype(np.float32)
    return x, w, run_world("spatial", (x, w),
                           tmp_path_factory.mktemp("spatial"))


@pytest.mark.parametrize("boundary", ["edge", "zero"])
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_d_equals_jax(spatial_world, boundary, halo):
    from jax import shard_map
    x, _, ranks = spatial_world
    mesh = JP.create_mesh(1, 2)
    f = shard_map(lambda s: j_halo_exchange_d(s, halo, boundary=boundary),
                  mesh=mesh, in_specs=(P(None, "space"),),
                  out_specs=P(None, "space"))
    want = np.asarray(f(jnp.asarray(x)))
    per = x.shape[1] // 2 + 2 * halo
    for r, out in enumerate(ranks):
        assert out["shape"] == {"data": 1, "space": 2}
        assert out["coords"] == (0, r) and out["grid"] == [[0, 1]]
        assert out["constrained"] == (1, 4, 6, 5, 3)
        np.testing.assert_array_equal(out[f"{boundary}{halo}"],
                                      want[:, r * per:(r + 1) * per])


@pytest.mark.parametrize("which", ["sharded", "zero_boundary"])
def test_sharded_convs_equal_the_global_conv(spatial_world, which):
    x, w, ranks = spatial_world
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=dn))
    got = np.concatenate([r[which] for r in ranks], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- inference

@pytest.fixture(scope="module")
def inference_world(tmp_path_factory):
    rng = np.random.default_rng(1)
    plain = UNet3D(features=(8, 16), seed=1, device="cpu")
    ps2d = UNet3D(features=(32, 64), seed=2, device="cpu",
                  ps2d_eval=True, ps2d_levels=2)
    vols = rng.normal(size=(5, 16, 16, 16, 4)).astype(np.float32)
    vol = rng.normal(size=(24, 24, 16, 4)).astype(np.float32)
    ranks = run_world("inference", (_state(plain), _state(ps2d), vols, vol),
                      tmp_path_factory.mktemp("inference"))
    return plain, ps2d, vols, vol, ranks


def _jax_unet(model, features, names_to_bf16=()):
    """JAX's normal-path U-Net in f32 on ``model``'s weights, the named
    ones rounded to bf16."""
    sd = {k: (v.to(torch.bfloat16).float() if k in names_to_bf16 else v)
          for k, v in model.state_dict().items()}
    return (JUNet3D(out_channels=4, features=features, dtype=jnp.float32),
            _jvars(to_flax_variables(sd)))


def test_segment_cohort_equals_jax_single_device(inference_world):
    plain, _, vols, _, ranks = inference_world
    jm, jv = _jax_unet(plain, (8, 16))
    want = JP.segment_cohort(jm, jv, JP.create_mesh(1, 1), vols)
    for out in ranks:
        assert out["mesh"] == {"data": 2, "space": 1}
        assert out["cohort"].dtype == np.int8
        np.testing.assert_array_equal(out["cohort"], want)


def test_segment_cohort_whole_equals_jax_single_device(inference_world):
    plain, _, vols, _, ranks = inference_world
    jm, jv = _jax_unet(plain, (8, 16))
    labels, conf = JP.segment_cohort_whole(jm, jv, JP.create_mesh(1, 1),
                                           vols, (16, 16, 16))
    for out in ranks:
        got_l, got_c = out["whole"]
        assert got_l.shape == (5, 16, 16, 16) and got_c.dtype == np.float32
        np.testing.assert_array_equal(got_l, np.asarray(labels))
        np.testing.assert_allclose(got_c, np.asarray(conf), rtol=0,
                                   atol=1e-5)


def _jax_window(jm, jv, vol):
    def apply_fn(v, p):
        return jm.apply(v, p, train=False)["logits"]
    return np.asarray(j_sliding_window_inference(
        jv, jnp.asarray(vol), apply_fn, roi_size=(16, 16, 16), overlap=0.5,
        sw_batch_size=2))


def test_window_parallel_equals_jax(inference_world):
    plain, _, _, vol, ranks = inference_world
    want = _jax_window(*_jax_unet(plain, (8, 16)), vol)
    for out in ranks:
        np.testing.assert_allclose(out["window"], want, atol=1e-4,
                                   rtol=1e-3)
    np.testing.assert_array_equal(ranks[0]["window"], ranks[1]["window"])


def test_window_parallel_ps2d_equals_jax(inference_world):
    _, ps2d, _, vol, ranks = inference_world
    levels = ranks[0]["halo_levels"]
    assert levels == 2
    want = _jax_window(*_jax_unet(ps2d, (32, 64),
                                  ps2d.k1_kernel_names(levels)), vol)
    for out in ranks:
        assert out["pools"] == 1        # one forward of 2 windows a rank
        np.testing.assert_allclose(out["window_ps2d"], want, atol=1e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(out["window_ps2d"],
                                   out["window_ps2d_one"], atol=1e-4,
                                   rtol=1e-3)
