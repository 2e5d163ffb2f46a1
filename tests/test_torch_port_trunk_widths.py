"""The port's fused trunk over the reference's whole domain.

`poseprobe_tpu.ops.pallas.fused_mlp` takes any uniform trunk width that is a
multiple of 128, one skip strictly inside, and an encoded input of up to 128.
Here, on the CPU:

* the port's `supports` against the reference's on a grid of scene configs
  (widths 48 / 128 / 256 / 384 / 512, L_3D 10 / 11 / 16 / 20 / 21, raw xyz on
  and off, one and two skips);
* the twin (`fused_trunk` on CPU tensors) against the Pallas kernel in
  interpret mode at (H 128, L 3, D 99), (H 128, L 4, D 39, pad 64, the skip
  on the last layer), (H 384, L 3, D 39), (H 512, L 2, D 123) and (H 640, L
  3, D 63, the skip on the last layer), forward and VJP, with
  `tests/test_torch_port_trunk.py`'s tolerances (1e-2 abs forward; gradients
  within 2e-2 of their max);
* which kernel takes which shape (`in_pad`, `kernel_name`, the backward's
  scratch), and the wrapper's refusals, which run before any CUDA call;
* the layout facts the wide kernels (`csrc/trunk_wide.cu`) rely on, for H in
  {384, 512, 640, 1024} and both pads: their column tiles, every weight and
  operand box inside its tensor, 16-byte strides and bases, and the launch
  plan (`wide_plan`: clusters, dW tiles and point slices) and scratch sizes
  the wrapper passes;
* the launch plan of the H = 128 chain (`csrc/trunk_narrow.cu`,
  `narrow_plan`): its grid, tiles, db scratch and shared memory;
* the parameter converter carrying a 128- and a 512-wide trunk both ways.

The kernels themselves are held against the twin on the card
(`tests/test_torch_port_cuda.py`, `chip_smoke.py`).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.models import scene_nerf as j_scene
from poseprobe_tpu.ops.pallas import fused_mlp as j_fused
from poseprobe_tpu_torch import convert
from poseprobe_tpu_torch.models import scene_nerf as t_scene
from poseprobe_tpu_torch.ops import fused_mlp as t_fused

torch.set_num_threads(1)


@pytest.mark.parametrize("width,L_3D", list(itertools.product((48, 128, 256, 384, 512), (10, 11, 16, 20, 21))))
def test_supports_equals_the_reference(width, L_3D):
    """Each (width, L_3D) with raw xyz on and off, one skip and two: the
    port's `supports` is the reference's."""
    for add_raw, skip in itertools.product((True, False), ((4,), (2, 6))):
        kw = dict(layers_feat=(width,) * 8, L_3D=L_3D, add_raw_3d=add_raw, skip=skip)
        want = j_fused.supports(j_scene.SceneConfig(**kw))
        assert t_fused.supports(t_scene.SceneConfig(**kw)) is want, kw
    # the grid reaches both answers, and an input of 128 is taken, 129 not
    assert t_fused.supports(t_scene.SceneConfig(layers_feat=(128,) * 8, L_3D=20, add_raw_3d=True))
    assert not t_fused.supports(t_scene.SceneConfig(layers_feat=(128,) * 8, L_3D=21, add_raw_3d=True))


def _layers(rng, H, L, D, skip):
    layers = []
    for li in range(L):
        d_in = (D if li == 0 else H) + (D if li == skip else 0)
        d_out = H + 1 if li == L - 1 else H
        bound = np.sqrt(2.0) * np.sqrt(6.0 / (d_in + d_out))
        layers.append({"w": rng.uniform(-bound, bound, (d_in, d_out)).astype(np.float32),
                       "b": rng.normal(0, 0.1, d_out).astype(np.float32)})
    return layers


def _to_torch(layers, requires_grad=False):
    return [{k: torch.tensor(v, requires_grad=requires_grad) for k, v in layer.items()} for layer in layers]


SHAPES = [(128, 3, 99, 1), (128, 4, 39, 3), (384, 3, 39, 1), (512, 2, 123, 1), (640, 3, 63, 2)]   # (H, L, D, skip)
N = 300


@pytest.mark.parametrize("H,L,D,skip", SHAPES)
def test_twin_forward_matches_pallas_interpret(H, L, D, skip):
    rng = np.random.default_rng(H + D)
    layers = _layers(rng, H, L, D, skip)
    enc = rng.normal(0, 1, (N, D)).astype(np.float32)
    raw_j, feat_j = j_fused.fused_trunk(jnp.asarray(enc), layers, skip, interpret=True)
    raw_t, feat_t = t_fused.fused_trunk(torch.tensor(enc), _to_torch(layers), skip)
    assert feat_t.shape == (N, H) and feat_t.dtype == torch.bfloat16 and raw_t.dtype == torch.float32
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=1e-2)
    np.testing.assert_allclose(feat_t.float().numpy(), np.asarray(feat_j, np.float32), atol=1e-2)


@pytest.mark.parametrize("H,L,D,skip", SHAPES)
def test_twin_gradients_match_pallas_interpret(H, L, D, skip):
    rng = np.random.default_rng(H + D + 1)
    layers = _layers(rng, H, L, D, skip)
    enc = rng.normal(0, 1, (N, D)).astype(np.float32)

    def f(params, e):
        raw, feat = j_fused.fused_trunk(e, params, skip, interpret=True)
        return jax.nn.softplus(raw).sum() + (feat.astype(jnp.float32) ** 2).sum()

    g_params, g_enc = jax.grad(f, argnums=(0, 1))(layers, jnp.asarray(enc))
    t_layers = _to_torch(layers, requires_grad=True)
    t_enc = torch.tensor(enc, requires_grad=True)
    raw, feat = t_fused.fused_trunk(t_enc, t_layers, skip)
    (torch.nn.functional.softplus(raw).sum() + (feat.float() ** 2).sum()).backward()
    for li in range(L):
        for k in ("w", "b"):
            a, b = np.asarray(g_params[li][k]), t_layers[li][k].grad.numpy()
            assert np.abs(a - b).max() <= 2e-2 * (np.abs(a).max() + 1e-6), (li, k)
    a, b = np.asarray(g_enc), t_enc.grad.numpy()
    assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max()


@pytest.mark.parametrize("H,D,pad,name", [
    (256, 63, 64, "trunk_{}"),                  # the 8x256 main path
    (256, 99, 128, "trunk_{}_h256_in128"),
    (128, 39, 64, "trunk_{}_h128_in64"),
    (128, 99, 128, "trunk_{}_h128_in128"),
    (384, 39, 64, "trunk_{}_wide"),
    (512, 123, 128, "trunk_{}_wide"),
    (1024, 63, 64, "trunk_{}_wide"),
])
def test_each_shape_has_its_kernel(H, D, pad, name):
    """The input pads to 64 up to 64 columns and to 128 past that; widths 128
    and 256 run csrc/fused_trunk.cu's instantiation for (H, pad), wider ones
    csrc/trunk_wide.cu; the backward's scratch holds every layer's g, and for
    the wide kernels the last layer's g with its 128 density columns."""
    assert t_fused.in_pad(D) == pad
    for kind in ("fwd", "bwd"):
        assert t_fused.kernel_name(kind, H, pad) == name.format(kind)
    L, skip, n = 4, 2, 10
    layers = [{"w": torch.zeros(((D if l == 0 else H) + (D if l == skip else 0), H + (l == L - 1))),
               "b": torch.zeros(H + (l == L - 1))} for l in range(L)]
    w, b = t_fused.pack_params(layers, skip)
    denc, dw, db, gsave = t_fused._bwd_outputs(n, w, b, L, pad)
    assert denc.shape == (n, pad) and dw.shape == w.shape and db.shape == b.shape
    assert gsave.numel() == L * n * H + (0 if H <= 256 else n * t_fused.DENS_PAD)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The checks in front of a launch, which run before any CUDA call."""
    L, skip = 3, 1
    w = torch.zeros(t_fused.layout(L, skip, 192, 64)[-1][2] + 192 * (192 + 128), dtype=torch.bfloat16)
    b = torch.zeros(L * 192 + 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        t_fused._check_inputs(L, skip, torch.zeros((8, 64), dtype=torch.bfloat16), w, b)
    layers = _to_torch(_layers(np.random.default_rng(0), 128, L, 99, skip))
    w, b = t_fused.pack_params(layers, skip)
    with pytest.raises(ValueError, match="64 or 128"):
        t_fused._check_inputs(L, skip, torch.zeros((8, 96), dtype=torch.bfloat16), w, b)
    with pytest.raises(ValueError, match="layout"):
        t_fused._check_inputs(L, skip, torch.zeros((8, 64), dtype=torch.bfloat16), w, b)
    assert t_fused._check_inputs(L, skip, torch.zeros((8, 128), dtype=torch.bfloat16), w, b) == (128, 128)
    with pytest.raises(ValueError, match="1..128"):
        t_fused.in_pad(129)


@pytest.mark.parametrize("width,L_3D", [(128, 16), (512, 10)])
def test_converter_carries_the_trunk(width, L_3D):
    """A JAX scene param tree with a `width`-wide trunk goes to the port and
    back unchanged, under the JAX checkpoint's keypaths, and the port's f32
    `nerf_forward` on it gives JAX's values."""
    kw = dict(layers_feat=(width,) * 8, L_3D=L_3D, layers_rgb=(64, 3), L_view=2)
    jcfg, tcfg = j_scene.SceneConfig(**kw), t_scene.SceneConfig(**kw)
    params = jax.tree.map(np.asarray, j_scene.init_nerf_mlp(jax.random.PRNGKey(width), jcfg))
    carried = convert.scene_params_from_jax(params, "cpu")
    assert [la["w"].shape[1] for la in carried["feat"]] == [width] * 7 + [width + 1]
    back = convert.tree_to_numpy(carried)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [k for k, _ in convert.keyed_leaves(carried)] == paths
    rng = np.random.default_rng(width)
    points = rng.normal(0, 1, (1, 3, 5, 3)).astype(np.float32)
    ray = rng.normal(0, 1, (1, 3, 3)).astype(np.float32)
    out_j = j_scene.nerf_forward(params, jcfg, jnp.asarray(points), jnp.asarray(ray), 0.3)
    out_t = t_scene.nerf_forward(carried, tcfg, torch.tensor(points), torch.tensor(ray), 0.3)
    for k in ("rgb_samples", "density_samples"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-5, atol=1e-5)


def _wide_gemms(L: int, skip: int, width: int, pad: int) -> list:
    """Per layer, what csrc/trunk_wide.cu's launch functions give the
    forward's and the chain's GEMM of that layer: {"fwd": ..., "chain": ...},
    each a dict of the reduction depth K, the reduction index ka from which A
    is read from the encoding (the forward; the chain's A is g alone), the
    layer's first row kb0 in its weight map (layers 0..L-2 stacked as [rows,
    H], the last as [K, H + 128]), and the column tiles: [0, cm) and one extra
    tile of xw columns at cm (the density column of the last forward, the
    encoding inputs of the chain's skip layer and layer 0). The last layer's
    chain reduces over H + 64 of its H + 128 columns: g is zero past the
    density column H."""
    out = []
    for l, (K, NO, wo, _) in enumerate(t_fused.layout(L, skip, width, pad)):
        last = l == L - 1
        kb0 = 0 if last else wo // width
        fwd = dict(K=K, ka=0 if l == 0 else width, kb0=kb0, cm=width, xw=64 if last else 0)
        red = width + 64 if last else width
        chain = dict(K=red, ka=red, kb0=kb0, cm=width if l > 0 else 0, xw=pad if l in (0, skip) else 0)
        out.append({"fwd": fwd, "chain": chain})
    return out


@pytest.mark.parametrize("pad", [64, 128])
@pytest.mark.parametrize("H", [384, 512, 640, 1024])
def test_wide_kernels_tiles_boxes_and_plan(H, pad):
    """What csrc/trunk_wide.cu takes from the wrapper and its layout, for an
    8-layer trunk with the skip at 4 and at 7 (the last layer):
    * each GEMM's column tiles (`wide_col_tiles` of `_wide_gemms`) are 256
      wide but for a 128 tail and the one extra tile, 64 or 128 wide, and
      cover its outputs without a gap: the forward's H feature columns and,
      last, the density column; the chain's K_l inputs;
    * every 64 x 64 weight box a launch reads lies inside its layer's block of
      its map (layers 0..L-2 stacked as [rows, H], the last as [K, H + 128]);
      every A box's columns inside the activation, g or encoding it reads;
    * the dW grid's clusters are every layer's pairs of 128-feature tiles
      times its column tiles (which cover its outputs), and its point slices
      (`wide_plan`) are whole 64-point chunks, none empty, covering n;
    * row strides and per-layer bases in bytes are multiples of 16 (TMA), and
      the backward's scratch and the forward's slots are the sizes the C side
      indexes."""
    sms = 132
    for skip in (4, 7):
        L = 8
        lay = t_fused.layout(L, skip, H, pad)
        hidden_rows = lay[-1][2] // H
        plans = _wide_gemms(L, skip, H, pad)
        for l, ((K, NO, wo, _), p) in enumerate(zip(lay, plans)):
            last = l == L - 1
            map_rows, map_cols = (K, H + t_fused.DENS_PAD) if last else (hidden_rows, H)
            base = 0 if last else wo // H
            assert (wo * 2) % 16 == 0 and (last or wo % H == 0)
            fwd, chain = p["fwd"], p["chain"]
            for g, n_out in ((fwd, H + 64 if last else H), (chain, K)):
                tiles = t_fused.wide_col_tiles(g["cm"], g["xw"])
                assert [c0 for c0, _ in tiles] == [sum(w for _, w in tiles[:i]) for i in range(len(tiles))]
                assert sum(w for _, w in tiles) == n_out
                assert all(w == 256 for _, w in tiles[:-2]) and {w for _, w in tiles} <= {64, 128, 256}
                assert g["kb0"] == base and g["K"] % 64 == 0
            assert fwd["K"] == K and chain["K"] == (H + 64 if last else H)
            # forward: rows kb0 + k of the layer, columns c0 + 64 i (feat, then the density column H)
            for k in range(0, fwd["K"], 64):
                for c0, w in t_fused.wide_col_tiles(fwd["cm"], fwd["xw"]):
                    for x in range(c0, c0 + w, 64):
                        assert base <= fwd["kb0"] + k and fwd["kb0"] + k + 64 <= base + K <= map_rows
                        assert x + 64 <= map_cols and x < NO
                assert (k - fwd["ka"] + 64 <= pad) if k >= fwd["ka"] else (k + 64 <= H)
            assert fwd["ka"] == (0 if l == 0 else H) and K - fwd["ka"] == (pad if l in (0, skip) else 0)
            # chain: rows kb0 + c0 + 64 i (the layer's inputs), columns k (its outputs); A is g alone
            for c0, w in t_fused.wide_col_tiles(chain["cm"], chain["xw"]):
                for y in range(c0, c0 + w, 64):
                    assert chain["kb0"] + y + 64 <= base + K <= map_rows
            assert chain["K"] <= map_cols and chain["ka"] == chain["K"]
            assert chain["K"] <= (H + t_fused.DENS_PAD if last else H)
            assert chain["cm"] == (H if l > 0 else 0) and chain["cm"] + chain["xw"] == K
        for n in (1, 63, 64, 65, 100_003, 393_216):
            plan = t_fused.wide_plan(n, L, skip, H, pad, sms)
            assert plan["clusters"] == sms // 2 and plan["slots"] == 2
            # dW: pairs of 128-feature tiles (the last one past K when a layer has an odd count) times the
            # column tiles, the last layer's 128 columns from H in one tile
            pairs = 0
            for l, (K, NO, *_) in enumerate(lay):
                ct = t_fused.wide_col_tiles(H, 128 if l == L - 1 else 0)
                assert sum(w for _, w in ct) == NO and {w for _, w in ct} <= {128, 256}
                pairs += -(-K // 256) * len(ct)
            rows, splits = plan["dw_rows_per_split"], plan["dw_splits"]
            assert plan["dw_pairs"] == pairs and rows % 64 == 0 and 1 <= splits <= 32
            assert (splits - 1) * rows < n <= splits * rows
            w = torch.zeros(lay[-1][2] + lay[-1][0] * lay[-1][1], dtype=torch.bfloat16)
            b = torch.zeros(L * H + t_fused.DENS_PAD, dtype=torch.bfloat16)
            denc, dw, db, gsave = t_fused._bwd_outputs(n, w, b, L, pad)
            # gsave: g_0 .. g_{L-2} as [n, H], then the last layer's g as [n, H + 128]
            assert gsave.numel() == (L - 1) * n * H + n * (H + t_fused.DENS_PAD)
            for nbytes in (H * 2, (H + t_fused.DENS_PAD) * 2, pad * 2, n * H * 2, (L - 1) * n * H * 2):
                assert nbytes % 16 == 0


@pytest.mark.parametrize("pad", [64, 128])
def test_narrow_chain_plan(pad):
    """What the wrapper passes csrc/trunk_narrow.cu's chain (`narrow_plan`;
    its C side refuses another plan), for an 8 x 128 trunk on cards of 132,
    114 and 8 multiprocessors:
    * one persistent block per multiprocessor, never more than the 256-point
      tiles (four 64-point chains a tile), and the blocks' turns cover the
      tiles, ceil(n / 256), with no block idle;
    * the db scratch: 16 copies a block (one per consumer warp) of db's first
      L * 128 + 1 entries, every layer's columns and then the last layer's
      density column (the packed layout puts it at L * 128);
    * the block's shared memory, 1 KB of alignment + a 2-stage ring of 16 KB
      weight stages + 3 slots of 16 KB per warpgroup + the density column of
      W_last in f32 + the mbarriers, fits the 227 KB a block may have."""
    L, skip, H = 8, 4, t_fused.NARROW_WIDTH
    lay = t_fused.layout(L, skip, H, pad)
    assert lay[-1][3] + H == L * H and sum(NO for _, NO, *_ in lay) == L * H + t_fused.DENS_PAD
    for sms in (132, 114, 8):
        for n in (1, 127, 256, 257, 100_003, 393_216):
            plan = t_fused.narrow_plan(n, L, pad, sms)
            tiles = -(-n // t_fused.NARROW_TILE)
            assert t_fused.NARROW_TILE == 4 * 64 and plan["tiles"] == tiles
            assert plan["blocks"] == min(sms, tiles) >= 1
            per = plan["tiles_per_block"]
            assert (per - 1) * plan["blocks"] < tiles <= per * plan["blocks"]
            assert plan["db_part"] == plan["blocks"] * t_fused.NARROW_WARPS * (L * H + 1)
            box = 64 * 64 * 2
            parts = (1024, t_fused.NARROW_RING * 2 * box, 4 * t_fused.NARROW_SLOTS * 2 * box, (H + pad) * 4,
                     (2 * t_fused.NARROW_RING + 4 * t_fused.NARROW_SLOTS) * 8)
            assert t_fused.NARROW_RING >= 2 and t_fused.NARROW_SLOTS >= 3
            assert plan["smem"] == sum(parts) <= 232_448   # the shared memory a block may have on an H100
