"""Z-sharded grids of the port (`parallel/grid_tp.py`, `parallel/object_tp.py`)
held against the JAX package's functions.

Two jobs of gloo ranks on the CPU (`torch_port_parallel_ranks.py`): two ranks
for the (1, 2) and (2, 1) meshes, four for (1, 4) and (2, 2). Each rank
takes its slab of the grid with `shard_grid`; the JAX references run here on
the conftest's virtual CPU devices, on the inputs and at the tolerances of
`tests/test_grid_tp.py`:

* `sample_grid_tp` values for 2 and 4 slabs (atol 2e-5, with points on the
  slab seams, the box faces and outside), and its gradients for the grid and
  the points (atol 5e-5) away from cell seams, where the trilinear derivative
  is one-sided; data-sharded points on (2, 2), values and gradients;
* `total_variation_tp` with and without a mask (rtol 1e-6) and its gradient
  (atol 2e-5);
* the indivisible-Z error;
* `train_step_tp` on (1, 2) and (2, 1) and `joint_step_tp` on (2, 2): the loss
  within 1e-5, the updated slabs and the scene parameters at rtol 2e-4 /
  atol 2e-6, the se3 deltas at rtol 1e-3 / atol 1e-6. The update is plain
  SGD, so a gradient off by the number of ranks fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_grid_tp as jtp
import torch_port_parallel_ranks as ranks
from poseprobe_tpu.models.scene_nerf import SceneConfig as JSceneConfig
from poseprobe_tpu.parallel import grid_tp as jgrid_tp, object_tp as jobject_tp
from poseprobe_tpu_torch.core.tree import tree_leaves

torch.set_num_threads(1)

SCENE_KW = dict(layers_feat=(32,) * 3, layers_rgb=(16, 3), skip=(1,), L_3D=2, L_view=1, sample_intvs=8,
                sample_intvs_fine=8, rand_rays=24, max_iter=100, barf_c2f=None, fine_sampling=False)
STEP_KW = dict(near=1.0, far=3.5, n_samples=32, xyz_min=(-0.5,) * 3, xyz_max=(0.5,) * 3, s_val=0.05)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grid_inputs():
    seams = _np(jtp._setup())
    smooth = _np(jtp._setup(n=97, seams=False))
    dsh, dsh_smooth = _np(jtp._setup(n=256)), _np(jtp._setup(n=256, seams=False))
    tv_grid = np.asarray(jtp._setup(C=2, Z=16)[0])
    tv_mask = np.random.RandomState(3).rand(*tv_grid.shape) > 0.4
    return dict(seams=seams, smooth=smooth, dsh=dsh, dsh_smooth=dsh_smooth, tv_grid=tv_grid, tv_mask=tv_mask,
                tv_grad=np.asarray(jtp._setup(C=1, Z=8)[0]), z15=np.asarray(jtp._setup(Z=15)[0]),
                obj=_np(jtp.TestObjectStepTP()._inputs()), joint=jtp.TestJointStepTP()._inputs())


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inp = _grid_inputs()
    params, cfg, rays_cam, base, tgt, msk = inp["joint"]
    assert cfg == JSceneConfig(**SCENE_KW)
    sample = lambda shape, key, dsh=False: ("sample", dict(  # noqa: E731
        shape=shape, grid=inp[key][0], pts=inp[key][1], lo=inp[key][2], hi=inp[key][3], data_sharded=dsh))
    train = lambda shape: ("train_step", dict(shape=shape, sdf=inp["obj"][0], k0=inp["obj"][1],  # noqa: E731
                                             rays_o=inp["obj"][2], rays_d=inp["obj"][3], tgt=inp["obj"][4],
                                             msk=inp["obj"][5], **STEP_KW))
    two = {"sample2": sample((1, 2), "seams"), "grad2": sample((1, 2), "smooth"),
           "tv": ("tv", dict(shape=(1, 2), grid=inp["tv_grid"], mask=None)),
           "indivisible": ("indivisible", dict(shape=(1, 2), grid=inp["z15"])),
           "train12": train((1, 2)), "train21": train((2, 1))}
    four = {"sample4": sample((1, 4), "seams"), "grad4": sample((1, 4), "smooth"),
            "tv": ("tv", dict(shape=(1, 4), grid=inp["tv_grid"], mask=None)),
            "tv_mask": ("tv", dict(shape=(1, 4), grid=inp["tv_grid"], mask=inp["tv_mask"])),
            "tv_grad": ("tv", dict(shape=(1, 4), grid=inp["tv_grad"], mask=None)),
            "indivisible": ("indivisible", dict(shape=(1, 4), grid=inp["z15"])),
            "dsh": sample((2, 2), "dsh", True), "dsh_grad": sample((2, 2), "dsh_smooth", True),
            "joint22": ("joint_step", dict(shape=(2, 2), params=_np(params), scene_kw=SCENE_KW,
                                           rays_cam=np.asarray(rays_cam), base=np.asarray(base),
                                           tgt=np.asarray(tgt), msk=np.asarray(msk), progress=1.0, **STEP_KW))}
    out = {}
    for world, cases in ((2, two), (4, four)):
        res = ranks.launch(tmp_path_factory.mktemp(f"ranks{world}"), world, list(cases.values()), timeout_s=300)
        out[world] = [{name: r[i] for i, name in enumerate(cases)} for r in res]
    return inp, out


def _rank_coords(world, shape):
    return [divmod(r, shape[1]) for r in range(world)]


def _slab(full, s, G):
    Zl = full.shape[-1] // G
    return full[..., s * Zl:(s + 1) * Zl]


def _jax_sample(key_inputs, shape, dsh=False, grads=False):
    """The JAX function's values (and gradients of sum(sin(values)))."""
    grid, pts, lo, hi = (jnp.asarray(a) for a in key_inputs)
    mesh = jgrid_tp.make_grid_mesh(*shape)
    f = lambda g, p: jgrid_tp.sample_grid_tp(g, p, lo, hi, mesh, data_sharded_points=dsh)  # noqa: E731
    out = np.asarray(jax.jit(f)(grid, pts))
    if not grads:
        return out, None, None
    gg, gp = jax.jit(jax.grad(lambda g, p: jnp.sum(jnp.sin(f(g, p))), argnums=(0, 1)))(grid, pts)
    return out, np.asarray(gg), np.asarray(gp)


@pytest.mark.parametrize("world,name,grads", [(2, "sample2", False), (4, "sample4", False),
                                              (2, "grad2", True), (4, "grad4", True)])
def test_sample_parity(job, world, name, grads):
    inp, out = job
    key = "smooth" if grads else "seams"
    ref, g_ref, gp_ref = _jax_sample(inp[key], (1, world), grads=grads)
    for r in range(world):
        got = out[world][r][name]
        np.testing.assert_allclose(got["out"], ref, atol=2e-5)
        if grads:
            np.testing.assert_allclose(got["g_grid"], _slab(g_ref, r, world), atol=5e-5)
            np.testing.assert_allclose(got["g_pts"], gp_ref, atol=5e-5)


@pytest.mark.parametrize("name,grads", [("dsh", False), ("dsh_grad", True)])
def test_data_sharded_points(job, name, grads):
    """Rays data-parallel x grid tensor-parallel on (2, 2): each rank samples
    its data share of the points against its slab."""
    inp, out = job
    key = "dsh_smooth" if grads else "dsh"
    ref, g_ref, gp_ref = _jax_sample(inp[key], (2, 2), dsh=True, grads=grads)
    n = ref.shape[0] // 2
    for r, (d, s) in enumerate(_rank_coords(4, (2, 2))):
        got = out[4][r][name]
        np.testing.assert_allclose(got["out"], ref[d * n:(d + 1) * n], atol=2e-5)
        if grads:
            np.testing.assert_allclose(got["g_grid"], _slab(g_ref, s, 2), atol=5e-5)
            np.testing.assert_allclose(got["g_pts"], gp_ref[d * n:(d + 1) * n], atol=5e-5)


@pytest.mark.parametrize("world,name,mask_key", [(2, "tv", None), (4, "tv", None), (4, "tv_mask", "tv_mask")])
def test_tv_parity(job, world, name, mask_key):
    inp, out = job
    grid = jnp.asarray(inp["tv_grid"])
    mask = None if mask_key is None else jnp.asarray(inp[mask_key])
    mesh = jgrid_tp.make_grid_mesh(1, world)
    ref = float(jax.jit(lambda v, m: jgrid_tp.total_variation_tp(v, mesh, m))(grid, mask))
    for r in range(world):
        np.testing.assert_allclose(out[world][r][name]["value"], ref, rtol=1e-6)


@pytest.mark.parametrize("name,key", [("tv_grad", "tv_grad"), ("tv", "tv_grid"), ("tv_mask", "tv_grid")])
def test_tv_gradient_parity(job, name, key):
    inp, out = job
    mask = jnp.asarray(inp["tv_mask"]) if name == "tv_mask" else None
    mesh = jgrid_tp.make_grid_mesh(1, 4)
    g_ref = np.asarray(jax.jit(jax.grad(lambda v: jgrid_tp.total_variation_tp(v, mesh, mask)))(jnp.asarray(inp[key])))
    for r in range(4):
        np.testing.assert_allclose(out[4][r][name]["g_grid"], _slab(g_ref, r, 4), atol=2e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_indivisible_z_raises(job, world):
    for r in range(world):
        assert "not divisible" in job[1][world][r]["indivisible"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_train_step_parity(job, shape):
    inp, out = job
    sdf, k0, ro, rd, tgt, msk = (jnp.asarray(a) for a in inp["obj"])
    mesh = jgrid_tp.make_grid_mesh(*shape)
    new_sdf, new_k0, m = jax.jit(lambda s, k: jobject_tp.train_step_tp(s, k, ro, rd, tgt, msk, mesh=mesh, **STEP_KW))(
        jgrid_tp.shard_grid(sdf, mesh), jgrid_tp.shard_grid(k0, mesh))
    name = f"train{shape[0]}{shape[1]}"
    for r, (d, s) in enumerate(_rank_coords(2, shape)):
        got = out[2][r][name]
        assert abs(got["metrics"]["loss"] - float(m["loss"])) < 1e-5
        for k in ("mse", "bce", "grad_sdf_norm", "grad_k0_norm"):
            np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(got["sdf"], _slab(np.asarray(new_sdf), s, shape[1]), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(got["k0"], _slab(np.asarray(new_k0), s, shape[1]), rtol=2e-4, atol=2e-6)


def test_joint_step_parity(job):
    inp, out = job
    params, cfg, rays_cam, base, tgt, msk = inp["joint"]
    mesh = jgrid_tp.make_grid_mesh(2, 2)
    p_s = dict(params, sdf=jgrid_tp.shard_grid(params["sdf"], mesh), k0=jgrid_tp.shard_grid(params["k0"], mesh))
    new, m = jax.jit(lambda p: jobject_tp.joint_step_tp(p, cfg, rays_cam, base, tgt, msk, progress=1.0, mesh=mesh,
                                                        **STEP_KW))(p_s)
    new = _np(new)
    for r, (d, s) in enumerate(_rank_coords(4, (2, 2))):
        got = out[4][r]["joint22"]
        assert abs(got["metrics"]["loss"] - float(m["loss"])) < 1e-5
        for k in ("mse_obj", "bce", "mse_scene", "grad_sdf_norm", "grad_se3_norm"):
            np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=2e-4, err_msg=k)
        for k in ("sdf", "k0"):
            np.testing.assert_allclose(got["params"][k], _slab(new[k], s, 2), rtol=2e-4, atol=2e-6, err_msg=k)
        np.testing.assert_allclose(got["params"]["se3"], new["se3"], rtol=1e-3, atol=1e-6)
        for a, b in zip(tree_leaves(got["params"]["scene"]), jax.tree.leaves(new["scene"])):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
