"""The work of one training step or one rendered band, counted from the
configuration's shapes (never from what the program happens to launch).

A trunk call is (points, takes_gradient). Its work: 2 x `trunk_macs`
operations a point forward, twice that backward (the input and the weight
gradients of every layer); its bytes are its own inputs and outputs (the
encoding, the weights, the features, the density; backward the incoming
gradients, the features it masks with, the encoding gradient and the weight
gradients), with no stored activation counted. A grid lookup is (points,
channels, with_grad, takes_gradient); its bytes are the points, the values
(and spatial gradients) out, and backward the cotangents in: the grid's own
rows are not counted, so its least time is a lower bound.
"""
from __future__ import annotations

BF16, F32 = 2, 4


def trunk_macs(sm: dict) -> int:
    """Multiply-adds a point of the trunk (unpadded): 491,264 at 8x256, skip 4."""
    D = (3 if sm["add_raw_3d"] else 0) + 6 * sm["L_3D"]
    H, L, skip = sm["layers_feat"][0], len(sm["layers_feat"]), sm["skip"][0]
    macs = 0
    for l in range(L):
        k_in = (D if l == 0 else H) + (D if l == skip else 0)
        macs += k_in * (H + 1 if l == L - 1 else H)
    return macs


def trunk_params(sm: dict) -> int:
    return trunk_macs(sm) + sum(sm["layers_feat"]) + 1          # weights + biases


def head_macs(sm: dict) -> int:
    """Multiply-adds a point of the scene's colour head: its feature part (the
    view encoding's part is a ray's, not a point's, and is not counted)."""
    d_in, macs = sm["layers_feat"][-1], 0
    for d_out in sm["layers_rgb"]:
        macs, d_in = macs + d_in * d_out, d_out
    return macs


def trunk_call_cost(sm: dict, points: int, backward: bool) -> tuple[float, float]:
    """(operations, bytes) of one trunk call, forward or backward."""
    D = (3 if sm["add_raw_3d"] else 0) + 6 * sm["L_3D"]
    pad = 64 if D <= 64 else 128
    H = sm["layers_feat"][-1]
    w_bytes = trunk_params(sm) * BF16
    if not backward:
        return 2.0 * trunk_macs(sm) * points, points * (pad * BF16 + H * BF16 + F32) + w_bytes
    # in: encoding, feature and density gradients, the features (the last ReLU's mask), weights;
    # out: the encoding gradient and the weight and bias gradients
    return (4.0 * trunk_macs(sm) * points,
            points * (pad * BF16 + H * BF16 + BF16 + H * BF16 + pad * BF16) + w_bytes + trunk_params(sm) * F32)


def lookup_cost(points: int, channels: int, with_grad: bool, backward: bool) -> float:
    """Bytes of one trilinear lookup (see the module's docstring)."""
    per = channels * (4 if with_grad else 1) * F32
    return points * (3 * F32 + per)


def scene_rays_per_view(cfg: dict, n_active: int) -> int:
    """Rays a view contributes to the main render: its patches times the patch size squared."""
    sm, sc = cfg["scene_model"], cfg["scene_train"]
    p = sc["depth_regu_patch_size"]
    return max(sm["rand_rays"] // n_active // p ** 2, 1) * p ** 2


def scene_trunk_calls(cfg: dict, n_active: int, flags: dict) -> list:
    """The scene branch's trunk calls of one training step: [(points, takes_gradient)]."""
    sm, sc = cfg["scene_model"], cfg["scene_train"]
    weights = dict(sc["loss_weight"])
    M = cfg["_matches"]
    corres = weights.get("corres") is not None
    rays = n_active * scene_rays_per_view(cfg, n_active) + (2 * M if corres else 0)
    S, Sf = sm["sample_intvs"], sm["sample_intvs_fine"]
    fine = sm["fine_sampling"] and flags["fine_on"]
    calls = [(rays * S, True)] + ([(rays * (S + Sf), True)] if fine else [])
    if flags["depth_cons_on"] and weights.get("depth_cons") is not None:
        if not corres:
            raise ValueError("depth consistency from fresh pixels is not counted")
        calls += [(M * S, False)] + ([(M * S, False)] if fine else [])          # the visibility render
        calls += [(M * S, True)] + ([(M * (S + Sf), True)] if fine else [])     # the render at the blended pose
    return calls


def object_counts(cfg: dict, n_active: int, mask_k: int) -> dict:
    """The object branch's work of one early step: its sample points (rays x
    the chord bound K), its grid lookups and its MLP multiply-adds."""
    om, ot = cfg["object_model"], cfg["object_train"]
    n_rays, M = ot["N_rand"], cfg["_matches"]
    pts = n_rays * mask_k
    lookups = [(pts, 1, True, True), (pts, 1 + om["rgbnet_dim"], False, True)]
    proj_pts = 2 * M * mask_k if n_active > 2 else 2 * M * cfg["_n_samples"]
    if ot["projection_dis_error"] > 0:
        lookups.append((proj_pts, 1, True, True))
    deform = [3] + [128] * 4 + [4]
    deform_macs = sum(a * b for a, b in zip(deform[:-1], deform[1:]))
    d_in = (3 + 3 * om["posbase_pe"] * 2 + 3 + 3 * om["viewbase_pe"] * 2
            + (om["rgbnet_dim"] if om["rgbnet_direct"] else om["rgbnet_dim"] - 3) + om["geo_rgb_dim"])
    rgb = [d_in] + [om["rgbnet_width"]] * (om["rgbnet_depth"] - 1) + [3]
    rgb_macs = sum(a * b for a, b in zip(rgb[:-1], rgb[1:]))
    deform_pts = pts + (proj_pts if n_active > 2 else 0)
    return {"points": pts, "lookups": lookups, "macs": deform_macs * deform_pts + rgb_macs * pts}


def train_step(cfg: dict, n_active: int, flags: dict, mask_k: int | None) -> dict:
    """The step's work: trunk calls, grid lookups and model FLOPs (forward
    2 x multiply-adds, backward twice the forward of what takes a gradient;
    recomputation not counted)."""
    sm = cfg["scene_model"]
    calls = scene_trunk_calls(cfg, n_active, flags)
    per_pt = trunk_macs(sm) + head_macs(sm)
    flops = sum(2.0 * per_pt * n * (3 if grad else 1) for n, grad in calls)
    lookups = []
    if flags["object_on"]:
        obj = object_counts(cfg, n_active, mask_k)
        lookups = obj["lookups"]
        flops += 2.0 * obj["macs"] * 3
    return {"trunk_calls": calls, "lookups": lookups, "flops": flops}


def render_band(cfg: dict, rays: int, chunk: int) -> dict:
    """The work of rendering `rays` rays in chunks of `chunk`: each chunk's
    coarse and fine trunk calls, forward only."""
    sm = cfg["scene_model"]
    S, Sf = sm["sample_intvs"], sm["sample_intvs_fine"]
    calls = []
    for c in range(0, rays, chunk):
        n = min(chunk, rays - c)
        calls += [(n * S, False)] + ([(n * (S + Sf), False)] if sm["fine_sampling"] else [])
    per_pt = trunk_macs(sm) + head_macs(sm)
    return {"trunk_calls": calls, "lookups": [], "flops": sum(2.0 * per_pt * n for n, _ in calls)}
