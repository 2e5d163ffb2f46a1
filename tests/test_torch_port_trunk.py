"""Fused scene trunk of the PyTorch port (`poseprobe_tpu_torch/ops/fused_mlp.py`).

On the CPU the port's `fused_trunk` runs the kernel's plain twin; it is held
against the Pallas kernel `poseprobe_tpu.ops.pallas.fused_mlp.fused_trunk` run
in interpret mode, at the shape `tests/test_pallas.py` uses and with its
tolerances (1e-2 abs forward; gradients within 2e-2 of their max). The CUDA
kernel itself is held against the twin by `tests/test_torch_port_cuda.py`
(skipped without a card) and by `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.models import scene_nerf as j_scene
from poseprobe_tpu.ops.pallas import fused_mlp as j_fused
from poseprobe_tpu_torch.models import scene_nerf as t_scene
from poseprobe_tpu_torch.ops import fused_mlp as t_fused

torch.set_num_threads(1)

H, L, SKIP, D, N = 128, 3, 1, 39, 700


def _layers(rng):
    layers = []
    for li in range(L):
        d_in = (D if li == 0 else H) + (D if li == SKIP else 0)
        d_out = H + 1 if li == L - 1 else H
        bound = np.sqrt(2.0) * np.sqrt(6.0 / (d_in + d_out))
        layers.append({"w": rng.uniform(-bound, bound, (d_in, d_out)).astype(np.float32),
                       "b": rng.normal(0, 0.1, d_out).astype(np.float32)})
    return layers


def _to_torch(layers, requires_grad=False):
    return [{k: torch.tensor(v, requires_grad=requires_grad) for k, v in layer.items()}
            for layer in layers]


def _loss_jax(raw, feat):
    return jax.nn.softplus(raw).sum() + (feat.astype(jnp.float32) ** 2).sum()


def _loss_torch(raw, feat):
    return torch.nn.functional.softplus(raw).sum() + (feat.float() ** 2).sum()


def test_twin_forward_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    layers = _layers(rng)
    enc = rng.normal(0, 1, (N, D)).astype(np.float32)          # N not a tile multiple
    raw_j, feat_j = j_fused.fused_trunk(jnp.asarray(enc), layers, SKIP, interpret=True)
    raw_t, feat_t = t_fused.fused_trunk(torch.tensor(enc), _to_torch(layers), SKIP)
    assert feat_t.dtype == torch.bfloat16 and raw_t.dtype == torch.float32
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=1e-2)
    np.testing.assert_allclose(feat_t.float().numpy(), np.asarray(feat_j, np.float32), atol=1e-2)


def test_twin_gradients_match_pallas_interpret():
    rng = np.random.default_rng(1)
    layers = _layers(rng)
    enc = rng.normal(0, 1, (N, D)).astype(np.float32)

    def f(params, e):
        return _loss_jax(*j_fused.fused_trunk(e, params, SKIP, interpret=True))

    g_params, g_enc = jax.grad(f, argnums=(0, 1))(layers, jnp.asarray(enc))
    t_layers = _to_torch(layers, requires_grad=True)
    t_enc = torch.tensor(enc, requires_grad=True)
    _loss_torch(*t_fused.fused_trunk(t_enc, t_layers, SKIP)).backward()
    for li in range(L):
        for k in ("w", "b"):
            a, b = np.asarray(g_params[li][k]), t_layers[li][k].grad.numpy()
            assert np.abs(a - b).max() <= 2e-2 * (np.abs(a).max() + 1e-6), (li, k)
    a, b = np.asarray(g_enc), t_enc.grad.numpy()
    assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max()


def test_twin_matches_unfused_trunk_arithmetic():
    """The twin's roundings: bf16-valued inputs, f32 products and bias, bf16
    between layers; the raw density stays f32 (the unfused bf16 path rounds it)."""
    rng = np.random.default_rng(2)
    layers = _layers(rng)
    enc = torch.tensor(rng.normal(0, 1, (64, D)).astype(np.float32))
    raw, feat = t_fused.fused_trunk(enc, _to_torch(layers), SKIP)
    x = enc.to(torch.bfloat16).float()
    a = x
    for li, layer in enumerate(layers):
        w = torch.tensor(layer["w"]).to(torch.bfloat16).float()
        bias = torch.tensor(layer["b"]).to(torch.bfloat16).float()
        inp = torch.cat([a, x], -1) if li == SKIP else a
        pre = inp @ w + bias
        if li < L - 1:
            a = torch.relu(pre).to(torch.bfloat16).float()
    np.testing.assert_allclose(raw.numpy(), pre[:, 0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(feat.float().numpy(),
                                  torch.relu(pre[:, 1:]).to(torch.bfloat16).float().numpy())


def test_packed_gradient_reaches_every_layer():
    rng = np.random.default_rng(3)
    layers = _to_torch(_layers(rng), requires_grad=True)
    w, b = t_fused.pack_params(layers, SKIP)
    lay = t_fused.layout(L, SKIP, H, 64)
    assert w.numel() == lay[-1][2] + lay[-1][0] * lay[-1][1] and b.numel() == L * H + t_fused.DENS_PAD
    (w.float().sum() + b.float().sum()).backward()
    for layer in layers:
        assert torch.all(layer["w"].grad == 1) and torch.all(layer["b"].grad == 1)


@pytest.mark.parametrize("cfg_kw,expected", [
    ({}, True),
    ({"layers_feat": (48,) * 4, "skip": (2,)}, False),
    ({"skip": (1, 4)}, False),
    ({"L_3D": 11}, True),            # encoded input 69: padded to 128, as the reference takes it
])
def test_supports(cfg_kw, expected):
    assert t_fused.supports(t_scene.SceneConfig(**cfg_kw)) is expected


SMALL = dict(layers_feat=(32,) * 4, layers_rgb=(16, 3), skip=(2,), L_3D=4, L_view=2,
             barf_c2f=(0.1, 0.5))


def test_nerf_forward_f32_matches_jax():
    """nerf_forward (plain trunk, view-PE split) values and parameter grads at f32."""
    jcfg, tcfg = j_scene.SceneConfig(**SMALL), t_scene.SceneConfig(**SMALL)
    params = jax.tree.map(np.asarray, j_scene.init_nerf_mlp(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(4)
    points = rng.normal(0, 1, (1, 5, 7, 3)).astype(np.float32)
    ray = rng.normal(0, 1, (1, 5, 3)).astype(np.float32)
    w_rgb = rng.normal(0, 1, (1, 5, 7, 3)).astype(np.float32)
    w_den = rng.normal(0, 1, (1, 5, 7)).astype(np.float32)

    def f(p):
        out = j_scene.nerf_forward(p, jcfg, jnp.asarray(points), jnp.asarray(ray), 0.3)
        return (out["rgb_samples"] * w_rgb).sum() + (out["density_samples"] * w_den).sum(), out

    (val_j, out_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    out_t = t_scene.nerf_forward(tp, tcfg, torch.tensor(points), torch.tensor(ray), 0.3)
    val_t = ((out_t["rgb_samples"] * torch.tensor(w_rgb)).sum()
             + (out_t["density_samples"] * torch.tensor(w_den)).sum())
    val_t.backward()
    for k in ("rgb_samples", "density_samples"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(g_j), jax.tree.leaves(jax.tree.map(lambda t: t.grad, tp))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the packed layout as the backward chain kernel's tensor maps read it


def _pack_case(L_, skip, H_, pad, seed):
    """Layers of a trunk of width H_ whose encoding (63 or 99 wide) pads to `pad`."""
    gen = torch.Generator().manual_seed(seed)
    D_ = 63 if pad == 64 else 99
    layers = []
    for l in range(L_):
        k_in = D_ if l == 0 else (H_ + D_ if l == skip else H_)
        k_out = H_ + 1 if l == L_ - 1 else H_
        layers.append({"w": torch.randn((k_in, k_out), generator=gen), "b": torch.randn(k_out, generator=gen)})
    return layers, gen


@pytest.mark.parametrize("H_,pad", [(256, 64), (256, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("L_,skip", [(8, 4), (8, 7), (3, 1), (2, 1)])
def test_packed_weights_read_as_the_chain_kernels_two_maps(L_, skip, H_, pad):
    """The chain kernel reads the weights through two 2-D tensor maps over the
    packed buffer: layers 0..L-2 as one [rows, H] matrix in which row
    w_offset(l) / H + k is W_l[k], and the last layer as [K, H + 128] from
    its offset. Both bases are 16-byte aligned, every row stride a multiple
    of 16 bytes, and each 64-row box of a layer stays inside it."""
    layers, _ = _pack_case(L_, skip, H_, pad, 0)
    w, _ = t_fused.pack_params(layers, skip)
    lay = t_fused.layout(L_, skip, H_, pad)
    last = lay[-1][2]
    hidden = w[:last].view(-1, H_)
    for l, (K, NO, wo, _) in enumerate(lay):
        assert wo * 2 % 16 == 0 and NO * 2 % 16 == 0 and K % 64 == 0
        Wl = w[wo:wo + K * NO].view(K, NO)
        ref = torch.nn.functional.pad(layers[l]["w"].to(torch.bfloat16), (0, 0, 0, K - layers[l]["w"].shape[0]))
        if l < L_ - 1:
            assert NO == H_ and wo % H_ == 0
            assert torch.equal(hidden[wo // H_:wo // H_ + K], Wl)
            assert torch.equal(Wl, ref)
        else:
            assert NO == H_ + t_fused.DENS_PAD and wo + K * NO == w.numel()
            assert torch.equal(Wl[:, :H_], ref[:, 1:]) and torch.equal(Wl[:, H_], ref[:, 0])


@pytest.mark.parametrize("H_,pad", [(256, 64), (256, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("L_,skip,n", [(8, 4, 130), (8, 7, 200), (3, 1, 64), (2, 1, 65)])
def test_forward_reads_and_writes_inside_its_maps(L_, skip, n, H_, pad):
    """The forward kernel's tensor maps. Its weight stage t of layer l is
    H / 64 boxes of 64 x 64 at row w_offset(l) / H + k0 of the hidden map
    (the last layer: row k0 of the last map, columns 0..H-1, never the
    density column), and each stays inside layer l. The point maps are 2-D
    [n, pad] (enc, pad / 64 boxes a row) and [n, H] (feat) and 3-D
    [L-1, n, H] (acts, so a box of layer l clips at row n and not in layer
    l+1), every row stride a multiple of 16 bytes."""
    layers, gen = _pack_case(L_, skip, H_, pad, L_ * 10 + skip)
    w, b = t_fused.pack_params(layers, skip)
    lay = t_fused.layout(L_, skip, H_, pad)
    hidden_rows, last_rows = lay[-1][2] // H_, lay[-1][0]
    y0 = 0
    for l, (K, NO, wo, _) in enumerate(lay):
        if l < L_ - 1:
            assert y0 == wo // H_
        for k0 in range(0, K, 64):
            y = k0 if l == L_ - 1 else y0 + k0
            assert y + 64 <= (last_rows if l == L_ - 1 else min(y0 + K, hidden_rows))
        y0 += K

    enc = torch.randn((n, pad), generator=gen).to(torch.bfloat16)
    assert t_fused.in_pad(layers[0]["w"].shape[0]) == pad and enc.stride() == (pad, 1) and pad % 64 == 0
    feat, dens, acts = t_fused.trunk_fwd(enc, w, b, L_, skip)
    assert feat.shape == (n, H_) and feat.stride() == (H_, 1) and dens.shape == (n,)
    assert acts.shape == (L_ - 1, n, H_) and acts.stride() == (n * H_, H_, 1)
    feat2, dens2, acts2 = t_fused.trunk_fwd(enc, w, b, L_, skip, store_acts=False)
    assert acts2 is None and torch.equal(feat2, feat) and torch.equal(dens2, dens)
