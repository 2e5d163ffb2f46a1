"""The scene encoding as the fused trunk takes it (`pe.posenc_scene_padded`)
and the paths around it, on the CPU.

On a CPU tensor `posenc_scene_padded` is its plain twin; the CUDA kernels
(`csrc/posenc.cu`) are held against the twin by `tests/test_torch_port_cuda.py`
(skipped without a card) and by `chip_smoke.py`. Here: the twin's columns
against the layout the kernel writes, column by column; its gradient against
the backward kernel's formula in float64; the rule that sends `nerf_forward`
to the padded encoding and the fused trunk; and `fused_trunk` taking an input
already at its padded width as it is.
"""
import math

import pytest
import torch

from poseprobe_tpu_torch.models import scene_nerf
from poseprobe_tpu_torch.ops import fused_mlp, pe
from poseprobe_tpu_torch.train import graphs

torch.set_num_threads(1)

BARF = (0.4, 0.7)
CASES = [(10, 64), (16, 128)]           # the 8x256 trunk's encoding, and the narrow preset's


def _points(n, scale=3.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 3), generator=g) * 2.0 - 1.0) * scale


def _layout(x, L, progress, pad, include_pi, add_raw):
    """The encoding column by column as the kernel writes it: the raw point,
    then for each channel c the L sines and the L cosines, column
    raw + c*2L + s*L + k = w_k * sin_or_cos(x_c * f_k); zeros up to pad. The
    sines and cosines are taken over the [N, 3, L] products, as the chain
    takes them, so that they are the same float32 values."""
    freqs = torch.tensor([math.ldexp(float(torch.tensor(math.pi if include_pi else 1.0)), k) for k in range(L)])
    spec = x[:, :, None] * freqs
    sc = (torch.sin(spec), torch.cos(spec))
    w = pe.barf_weights(progress, L, BARF, device="cpu")
    raw = 3 if add_raw else 0
    out = torch.zeros((x.shape[0], pad), dtype=torch.bfloat16)
    if add_raw:
        out[:, :3] = x.to(torch.bfloat16)
    for c in range(3):
        for s in range(2):
            for k in range(L):
                out[:, raw + c * 2 * L + s * L + k] = (sc[s][:, c, k] * w[k]).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("progress", [0.5, 1.0])          # inside the BARF window, and past it
@pytest.mark.parametrize("add_raw", [True, False])
@pytest.mark.parametrize("include_pi", [True, False])
@pytest.mark.parametrize("L,pad", CASES)
def test_padded_twin_writes_the_kernels_layout(L, pad, include_pi, add_raw, progress):
    x = _points(1001)                                        # not a multiple of a 64-point block
    enc = pe.posenc_scene_padded(x, L, progress, BARF, pad, include_pi=include_pi, add_raw=add_raw)
    assert enc.dtype == torch.bfloat16 and enc.shape == (1001, pad)
    assert torch.equal(enc.view(torch.int16), _layout(x, L, progress, pad, include_pi, add_raw).view(torch.int16))
    plain = pe.posenc_scene(x, L, progress, BARF, include_pi=include_pi, add_raw=add_raw).to(torch.bfloat16)
    assert torch.equal(enc[:, :plain.shape[1]], plain) and not enc[:, plain.shape[1]:].any()


def test_padded_twin_keeps_leading_dims():
    x = _points(2 * 5 * 7).reshape(2, 5, 7, 3)
    enc = pe.posenc_scene_padded(x, 10, 1.0, BARF, 64)
    assert enc.shape == (2, 5, 7, 64)
    assert torch.equal(enc.reshape(-1, 64), pe.posenc_scene_padded(x.reshape(-1, 3), 10, 1.0, BARF, 64))


@pytest.mark.parametrize("add_raw", [True, False])
@pytest.mark.parametrize("L,pad,progress", [(10, 64, 0.5), (16, 128, 1.0)])
def test_padded_twin_gradient_is_the_backward_kernels_formula(L, pad, progress, add_raw):
    """dx_c = denc_raw_c + sum_k w_k f_k (dsin_ck cos(x_c f_k) - dcos_ck sin(x_c f_k)),
    in float64 from the same float32 arguments x_c * f_k and bf16 cotangents, against autograd
    through the float32 twin: within 1e-5 of the sum of the terms' sizes
    (float32 rounding of L products and sums, in another order)."""
    x = _points(777).requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    denc = torch.randn((777, pad), generator=g).to(torch.bfloat16)
    pe.posenc_scene_padded(x, L, progress, BARF, pad, add_raw=add_raw).backward(denc)
    raw = 3 if add_raw else 0
    dd = denc.double()
    w = pe.barf_weights(progress, L, BARF, device="cpu").double()
    f32 = torch.tensor([math.ldexp(float(torch.tensor(math.pi)), k) for k in range(L)])
    f = f32.double()
    ds = torch.stack([dd[:, raw + c * 2 * L:raw + c * 2 * L + L] for c in range(3)], dim=1)       # [N, 3, L]
    dc = torch.stack([dd[:, raw + c * 2 * L + L:raw + c * 2 * L + 2 * L] for c in range(3)], dim=1)
    a = (x.detach()[:, :, None] * f32).double()             # the float32 argument both sides take
    terms = w * f * (ds * torch.cos(a) - dc * torch.sin(a))
    want = terms.sum(-1) + (dd[:, :3] if add_raw else 0.0)
    size = (w * f * (ds.abs() + dc.abs())).sum(-1) + (dd[:, :3].abs() if add_raw else 0.0)
    assert ((x.grad.double() - want).abs() <= 1e-5 * size + 1e-30).all()


@pytest.mark.parametrize("bad", [
    dict(x=torch.zeros(4, 2)),                               # not points
    dict(x=torch.zeros(4, 3, dtype=torch.float64)),          # not float32
    dict(pad=56),                                            # narrower than the 63 columns
    dict(pad=68),                                            # not a multiple of 8
    dict(pad=136),                                           # wider than the trunk takes
])
def test_padded_encoding_refuses_what_the_kernel_does_not_take(bad):
    args = dict(x=torch.zeros(4, 3), pad=64) | bad
    with pytest.raises(ValueError):
        pe.posenc_scene_padded(args["x"], 10, 1.0, BARF, args["pad"])


def _trunk(seed=0, L_3D=10, width=128, dtype="bfloat16"):
    cfg = scene_nerf.SceneConfig(layers_feat=(width,) * 3, skip=(1,), L_3D=L_3D, matmul_dtype=dtype)
    return cfg, scene_nerf.init_nerf_mlp(torch.Generator().manual_seed(seed), cfg)


@pytest.mark.parametrize("L_3D", [10, 16])                # pad 64, and pad 128
def test_fused_trunk_takes_a_padded_input_as_it_is(L_3D, monkeypatch):
    """`fused_trunk` on the encoding already bf16 and padded gives what it
    gives on the unpadded one, bit for bit (values and the layers' gradients),
    and hands the very tensor to the kernels' autograd function: no copy."""
    cfg, mlp = _trunk(L_3D=L_3D)
    D, pad = cfg.input_3d_dim, fused_mlp.in_pad(cfg.input_3d_dim)
    enc = pe.posenc_scene(_points(300), L_3D, 1.0, BARF).to(torch.bfloat16)
    padded = pe.posenc_scene_padded(_points(300), L_3D, 1.0, BARF, pad)
    seen = []
    apply = fused_mlp._FusedTrunk.apply
    monkeypatch.setattr(fused_mlp._FusedTrunk, "apply", lambda x, *a: seen.append(x) or apply(x, *a))

    def run(e):
        layers = [{k: v.clone().requires_grad_(True) for k, v in la.items()} for la in mlp["feat"]]
        raw, feat = fused_mlp.fused_trunk(e, layers, cfg.skip[0])
        (raw.sum() + feat.float().square().sum()).backward()
        return [raw, feat] + [la[k].grad for la in layers for k in ("w", "b")]

    assert enc.shape[1] == D and padded.shape[1] == pad
    for a, b in zip(run(enc), run(padded)):
        assert torch.equal(a, b)
    assert seen[1].data_ptr() == padded.data_ptr() and seen[0].data_ptr() != enc.data_ptr()


def _forward(cfg, mlp, points, ray, progress=0.6):
    out = scene_nerf.nerf_forward(mlp, cfg, points, ray, progress)
    return out["rgb_samples"], out["density_samples"]


def test_nerf_forward_takes_the_plain_encoding_off_the_fused_trunk(monkeypatch):
    """On CPU tensors, and in a float32 config, `nerf_forward` encodes with
    `posenc_scene` and never enters the padded encoding or the fused trunk."""
    def refuse(*a, **k):
        raise AssertionError("the plain path entered the fused trunk's encoding")
    monkeypatch.setattr(pe, "posenc_scene_padded", refuse)
    monkeypatch.setattr(fused_mlp, "fused_trunk", refuse)
    points, ray = _points(2 * 4 * 6).reshape(2, 4, 6, 3), _points(8, seed=1).reshape(2, 4, 3)
    for dtype in ("bfloat16", "float32"):
        cfg, mlp = _trunk(dtype=dtype)
        assert not scene_nerf._fused(cfg, points)
        rgb, dens = _forward(cfg, mlp, points, ray)
        assert rgb.shape == (2, 4, 6, 3) and dens.shape == (2, 4, 6) and torch.isfinite(rgb).all()


@pytest.mark.parametrize("L_3D", [10, 16])
def test_nerf_forward_on_the_fused_path_is_the_unpadded_chains(L_3D, monkeypatch):
    """The fused path (forced on the CPU, where the kernels' twins run) with
    the padded encoding gives what it gave with the plain chain's unpadded
    bf16 encoding, bit for bit: the outputs and the gradients of the
    parameters and of the points."""
    cfg, mlp = _trunk(L_3D=L_3D)
    monkeypatch.setattr(scene_nerf, "_fused", lambda cfg, points: True)
    g = torch.Generator().manual_seed(3)
    ray = torch.randn((2, 4, 3), generator=g)

    def run():
        params = {k: [{n: t.clone().requires_grad_(True) for n, t in la.items()} for la in v] for k, v in mlp.items()}
        points = _points(2 * 4 * 6).reshape(2, 4, 6, 3).requires_grad_(True)
        rgb, dens = _forward(cfg, params, points, ray)
        (rgb.square().sum() + dens.sum()).backward()
        return [rgb, dens, points.grad] + [t.grad for v in params.values() for la in v for t in la.values()]

    padded = run()

    def unpadded(x, L, progress, barf_c2f, pad, include_pi=True, add_raw=True):
        return pe.posenc_scene(x, L, progress, barf_c2f, include_pi=include_pi, add_raw=add_raw).to(torch.bfloat16)
    monkeypatch.setattr(pe, "posenc_scene_padded", unpadded)
    for a, b in zip(padded, run()):
        assert torch.equal(a, b)


def test_graph_replays_count_the_encoding_kernels():
    """A replay adds what its capture launched, the encoding's kernels too."""
    before = dict(pe.launches)
    launched = [0] * len(graphs._COUNTERS) + [0] * len(fused_mlp.KERNEL_NAMES) + [2, 1]
    assert len(launched) == len(graphs._counts())
    graphs._add_counts(launched)
    try:
        assert pe.launches == {"posenc_scene_fwd": before["posenc_scene_fwd"] + 2,
                               "posenc_scene_bwd": before["posenc_scene_bwd"] + 1}
    finally:
        graphs._add_counts([-n for n in launched])
    assert pe.launches == before
