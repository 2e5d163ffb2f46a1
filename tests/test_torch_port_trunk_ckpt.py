"""The trunk's activation-checkpoint strides, on the CPU.

The reference's trunk kernels (`poseprobe_tpu/ops/pallas/fused_mlp.py`) take a
checkpoint stride `ckpt` ($POSEPROBE_TRUNK_CKPT, default 1): the forward
stores the hidden layers `_stored_layers(L, ckpt)` (none at 0, all at 1, k-1,
2k-1, ... at k >= 2) and the backward recomputes the others from the nearest
stored layer before them. The port's `fused_trunk` takes the same strides.
Here, with the plain versions that the wrappers run on CPU tensors:

* `stored_layers` against the reference's `_stored_layers`;
* the port's trunk at ckpt 0, 2 and 3 against the Pallas kernels in
  interpret mode at the same stride, values and gradients, on
  `test_torch_port_trunk_widths.SHAPES` and the 8x128 trunk with skip 4,
  with that file's tolerances for the density (1e-2 abs) and the gradients
  (within 2e-2 of their max), and feat within 2e-2 of its max (a bf16
  rounding flip carries through the later layers: at 8 layers one exceeded
  1e-2), wherever the reference runs: a stride k >= 2 that stores no
  layer (k >= L) makes the reference's custom VJP fail, while the port takes
  it as stride 0;
* the port's results at ckpt 0, 2 and 3 equal to ckpt 1's bit for bit, the
  remat equal to the forward's every stored layer, and `_FusedTrunk` saving
  exactly the stride's layers;
* $POSEPROBE_TRUNK_CKPT=0 read by `fused_mlp.TRUNK_CKPT` in a fresh process
  and taken by `fused_trunk`.

The kernels (the forward's stored layers, the remat kernel, the backward at
each stride) are held on the card (`tests/test_torch_port_cuda.py`,
`chip_smoke.py`'s `drive_trunk_ckpt`).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseprobe_tpu.ops.pallas import fused_mlp as j_fused
from poseprobe_tpu_torch.ops import fused_mlp as t_fused
from test_torch_port_trunk_widths import SHAPES, _layers, _to_torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CKPT_SHAPES = SHAPES + [(128, 8, 63, 4)]   # (H, L, D, skip)
STRIDES = (0, 2, 3)
N = 300


def _loss_j(raw, feat):
    return jax.nn.softplus(raw).sum() + (feat.astype(jnp.float32) ** 2).sum()


def _loss_t(raw, feat):
    return torch.nn.functional.softplus(raw).sum() + (feat.float() ** 2).sum()


def _saved_acts(feat):
    """The stored layers that `_FusedTrunk` (under feat's reshape) saved."""
    return feat.grad_fn.next_functions[0][0].saved_tensors[4]


def _port(layers, enc, skip, ckpt):
    """(raw, feat, layer gradients, enc gradient) of the port's fused_trunk."""
    t_layers = _to_torch(layers, requires_grad=True)
    t_enc = torch.tensor(enc, requires_grad=True)
    raw, feat = t_fused.fused_trunk(t_enc, t_layers, skip, ckpt=ckpt)
    _loss_t(raw, feat).backward()
    return raw.detach(), feat.detach(), [[la[k].grad for k in ("w", "b")] for la in t_layers], t_enc.grad


@pytest.mark.parametrize("L", range(2, 11))
def test_stored_layers_equal_the_reference(L):
    for ckpt in range(-1, L + 1):
        assert t_fused.stored_layers(L, ckpt) == j_fused._stored_layers(L, ckpt), (L, ckpt)


# the reference's forward returns no stored layers for a stride k >= 2 that stores none (k >= L)
# and its custom VJP then fails to unpack them, so it is compared at the strides it runs
REFERENCE_CASES = [(*shape, k) for shape in CKPT_SHAPES for k in STRIDES
                   if k == 0 or j_fused._stored_layers(shape[1], k)]


@pytest.mark.parametrize("H,L,D,skip,ckpt", REFERENCE_CASES)
def test_strided_trunk_matches_pallas_interpret(H, L, D, skip, ckpt):
    """Values and gradients of the port's trunk at stride `ckpt` against the
    reference's kernels at the same stride."""
    rng = np.random.default_rng(H + D + 7 * ckpt)
    layers = _layers(rng, H, L, D, skip)
    enc = rng.normal(0, 1, (N, D)).astype(np.float32)

    def f(p, e):
        raw, feat = j_fused.fused_trunk(e, p, skip, interpret=True, ckpt=ckpt)
        return _loss_j(raw, feat), (raw, feat)

    (_, (raw_j, feat_j)), (g_params, g_enc) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        layers, jnp.asarray(enc))
    raw, feat, grads, genc = _port(layers, enc, skip, ckpt)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), atol=1e-2)
    # feat is bf16: where the two sum a pre-activation's f32 products in another order, a value near
    # a bf16 rounding boundary rounds to its neighbour and the flip carries through the later layers,
    # so feat is held as tests/test_torch_port_cuda.py holds the trunk's values: within 2e-2 of its max
    a = np.asarray(feat_j, np.float32)
    assert np.abs(feat.float().numpy() - a).max() <= 2e-2 * np.abs(a).max()
    for li in range(L):
        for i, k in enumerate(("w", "b")):
            a, b = np.asarray(g_params[li][k]), grads[li][i].numpy()
            assert np.abs(a - b).max() <= 2e-2 * (np.abs(a).max() + 1e-6), (li, k)
    a = np.asarray(g_enc)
    assert np.abs(a - genc.numpy()).max() <= 2e-2 * np.abs(a).max()


@pytest.mark.parametrize("H,L,D,skip", CKPT_SHAPES)
def test_every_stride_gives_the_results_of_stride_one(H, L, D, skip):
    """fused_trunk at ckpt 0, 2 and 3 (and past L) equals ckpt 1 bit for bit:
    values, every layer gradient and the encoding's gradient."""
    rng = np.random.default_rng(H + D + 2)
    layers = _layers(rng, H, L, D, skip)
    enc = rng.normal(0, 1, (N, D)).astype(np.float32)
    want = _port(layers, enc, skip, 1)
    for ckpt in STRIDES + (L + 1,):
        got = _port(layers, enc, skip, ckpt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ckpt
        assert all(torch.equal(a, b) for ga, gb in zip(got[2], want[2]) for a, b in zip(ga, gb)), ckpt
        assert torch.equal(got[3], want[3]), ckpt


@pytest.mark.parametrize("H,L,D,skip", CKPT_SHAPES)
def test_remat_refills_the_forwards_layers(H, L, D, skip):
    """The forward at each stride stores exactly its layers, each equal to the
    full forward's, and the remat rebuilds the full [L-1, N, H] bit for bit;
    the backward from the stored layers equals the backward from all."""
    rng = np.random.default_rng(H + D + 3)
    w, b = t_fused.pack_params(_to_torch(_layers(rng, H, L, D, skip)), skip)
    x = torch.nn.functional.pad(torch.tensor(rng.normal(0, 1, (N, D)), dtype=torch.bfloat16),
                                (0, t_fused.in_pad(D) - D))
    feat, dens, full = t_fused.trunk_fwd(x, w, b, L, skip)
    g_feat = torch.tensor(rng.normal(0, 1e-3, (N, H)), dtype=torch.bfloat16)
    g_dens = torch.tensor(rng.normal(0, 1e-3, N), dtype=torch.bfloat16)
    want = t_fused.trunk_bwd(x, g_feat, g_dens, feat, full, w, b, L, skip)
    for ckpt in STRIDES + (1, L + 1):
        stored = t_fused.stored_layers(L, ckpt)
        f, d, acts = t_fused.trunk_fwd(x, w, b, L, skip, store_acts=stored)
        assert torch.equal(f, feat) and torch.equal(d, dens)
        if stored:
            assert acts.shape == (len(stored), N, H) and torch.equal(acts, full[list(stored)])
        else:
            assert acts is None
        assert torch.equal(t_fused.trunk_remat(x, acts, w, b, L, skip, ckpt), full)
        got = t_fused.trunk_bwd(x, g_feat, g_dens, f, acts, w, b, L, skip, ckpt)
        assert all(torch.equal(p, q) for p, q in zip(got, want)), ckpt


@pytest.mark.parametrize("ckpt", (0, 1, 2, 3, 9))
def test_fused_trunk_saves_only_the_stored_layers(ckpt):
    """`_FusedTrunk` keeps the stride's layers as [n_stored, N, H] bf16 for
    the backward, or None when the stride stores none; a call that needs no
    gradient keeps none at any stride."""
    H, L, D, skip = 128, 8, 63, 4
    rng = np.random.default_rng(ckpt)
    layers = _layers(rng, H, L, D, skip)
    enc = torch.tensor(rng.normal(0, 1, (N, D)).astype(np.float32), requires_grad=True)
    raw, feat = t_fused.fused_trunk(enc, _to_torch(layers), skip, ckpt=ckpt)
    acts = _saved_acts(feat)
    n_stored = len(j_fused._stored_layers(L, ckpt))
    if n_stored:
        assert acts.shape == (n_stored, N, H) and acts.dtype == torch.bfloat16
    else:
        assert acts is None
    with torch.no_grad():
        t_fused.fused_trunk(enc, _to_torch(layers), skip, ckpt=ckpt)
    raw, feat = t_fused.fused_trunk(enc.detach(), _to_torch(layers), skip, ckpt=ckpt)
    assert raw.grad_fn is None and feat.grad_fn is None


def test_trunk_ckpt_environment_variable_is_taken():
    """A process started with POSEPROBE_TRUNK_CKPT=0 reads TRUNK_CKPT == 0,
    `fused_trunk` without a stride stores no layer, and its gradients are the
    ones of stride 1."""
    code = """if True:
        import numpy as np, torch
        from poseprobe_tpu_torch.ops import fused_mlp
        assert fused_mlp.TRUNK_CKPT == 0, fused_mlp.TRUNK_CKPT
        rng = np.random.default_rng(0)
        H, L, D, skip = 128, 4, 39, 2
        layers = []
        for l in range(L):
            d_in = (D if l == 0 else H) + (D if l == skip else 0)
            layers.append({"w": rng.normal(0, 0.1, (d_in, H + (l == L - 1))).astype(np.float32),
                           "b": rng.normal(0, 0.1, H + (l == L - 1)).astype(np.float32)})
        enc = rng.normal(0, 1, (200, D)).astype(np.float32)
        grads = []
        for ckpt in (None, 1):
            ls = [{k: torch.tensor(v, requires_grad=True) for k, v in la.items()} for la in layers]
            e = torch.tensor(enc, requires_grad=True)
            raw, feat = fused_mlp.fused_trunk(e, ls, skip, ckpt=ckpt)
            assert (feat.grad_fn.next_functions[0][0].saved_tensors[4] is None) == (ckpt is None)
            (raw.sum() + (feat.float() ** 2).sum()).backward()
            grads.append([la[k].grad for la in ls for k in ("w", "b")] + [e.grad])
        assert all(torch.equal(a, b) for a, b in zip(*grads))
        print("TRUNK_CKPT", fused_mlp.TRUNK_CKPT)
    """
    env = dict(os.environ, POSEPROBE_TRUNK_CKPT="0", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("TRUNK_CKPT 0")
