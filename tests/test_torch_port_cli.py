"""The port's CLIs, `python -m poseprobe_tpu_torch.run` and
`python -m poseprobe_tpu_torch.evaluate`, held against `run.py` and `eval.py`.

* A tiny synthetic run on the CPU (`--synthetic --tiny --cpu --steps 8
  --superstep 4 --i_ckpt 4 --render_test --export_mesh`), then `evaluate
  --cpu --eval_mesh` on its checkpoint: the files each writes and the keys of
  their JSON results. For the CPU's sake the test cuts what no flag reaches:
  the config's 100 test-time iterations to 2, the sample counts to --tiny's
  also when evaluating, the mesh volumes (128^3 and 256^3) to 24^3 and the
  chamfer's point sets to 5,000; and it passes `--n_test 1` and `--res 32`.
* `evaluate` on a checkpoint written by the JAX trainer at the same config.
* Every flag of `run.py` and `eval.py` is a flag of the port's CLIs, and
  the two parse the reference's flag values into the same config.
* `--grid_type tensorf` trains and checkpoints a TensoRF k0, which
  `evaluate` reads; `--match_source classical|superglue` match the synthetic
  views with the real matchers (SuperGlue on seeded random weights).
* A port preset loads by its file path, in the package or copied elsewhere;
  the options that once raised reach what they select; without `--cpu` and
  without a card the CLIs raise.
"""
import argparse
import dataclasses
import json
import os
import re
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from poseprobe_tpu_torch import evaluate as tevaluate, run as trun
from poseprobe_tpu_torch.config.presets import dtu_generic, dtu_scan, dtu_scan1
from poseprobe_tpu_torch.data import synthetic
from poseprobe_tpu_torch.eval import dtu_protocol
from poseprobe_tpu_torch.models import object_sdf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cpu_cuts(monkeypatch):
    """What no flag reaches, cut for the CPU: 2 test-time iterations, the
    --tiny sample counts also when evaluating, 24^3 mesh volumes, 5,000
    surface samples and GT points in the chamfer."""
    load, volume = trun.load_config, object_sdf.extract_sdf_volume
    score, surface = dtu_protocol.evaluate_mesh_dtu, synthetic.probe_surface_points

    def small(args):
        cfg = load(args)
        return dataclasses.replace(
            cfg, scene_train=dataclasses.replace(cfg.scene_train, test_iter=2),
            scene_model=dataclasses.replace(cfg.scene_model, sample_intvs=32, sample_intvs_fine=32))

    monkeypatch.setattr(trun, "load_config", small)
    monkeypatch.setattr(object_sdf, "extract_sdf_volume",
                        lambda params, cfg, resolution, **kw: volume(params, cfg, min(resolution, 24), **kw))
    monkeypatch.setattr(dtu_protocol, "evaluate_mesh_dtu", lambda *a, **kw: score(*a, **kw, n_samples=5000))
    monkeypatch.setattr(synthetic, "probe_surface_points", lambda **kw: surface(n=5000, **kw))


def test_run_then_evaluate_on_the_cpu(tmp_path, monkeypatch, cpu_cuts):
    monkeypatch.chdir(tmp_path)
    assert trun.main(["--synthetic", "--tiny", "--cpu", "--steps", "8", "--superstep", "4", "--i_ckpt", "4",
                      "--i_print", "4", "--n_test", "1", "--render_test", "--export_mesh"]) == 0
    out = tmp_path / "logs" / "synthetic"
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [4, 8] and all(np.isfinite(r["loss_total"]) for r in rows)
    assert {"rot_error", "trans_error", "psnr_scene", "wall"} <= set(rows[-1])
    ckpt = out / "last_ckpt.pkl"
    assert zipfile.is_zipfile(ckpt) and json.loads((out / "last_ckpt.pkl.json").read_text()) == {
        "expname": "synthetic"}
    manifest = json.loads(bytes(np.load(ckpt)["__manifest__"]).decode())
    assert manifest["scalars"]["step"] == 8 and {"generator", "num_voxels"} <= set(manifest["extras"])
    res = json.loads((out / "synthetic.json").read_text())
    assert {"psnr", "ssim", "psnr_per_img", "rot_error", "trans_error", "depth_abs", "steps",
            "train_seconds"} <= set(res) and res["steps"] == 8 and len(res["psnr_per_img"]) == 1
    assert (out / "meshes" / "deform_final.ply").read_text().startswith("ply\n")

    assert tevaluate.main(["--synthetic", "--cpu", "--n_test", "1", "--res", "32", "--ckpt", str(ckpt),
                           "--eval_mesh"]) == 0
    ev = out / "eval"
    res = json.loads((ev / "synthetic.json").read_text())
    assert res["iteration"] == 8 and set(res) == {"iteration", "w_test_optim", "without_test_optim"}
    assert {"psnr", "ssim_median", "rot_error"} <= set(res["w_test_optim"])
    assert (ev / "test_renders" / "test_000.png").exists()
    chamfer = json.loads((ev / "chamfer.json").read_text())
    if "error" in chamfer:       # an untrained probe may carry no surface: the failure record
        assert chamfer["error"] == "empty mesh"
    else:
        assert {"d2s", "s2d", "overall", "sim3_scale", "mesh_components"} <= set(chamfer)
        assert (ev / "mesh.ply").exists()


def test_tensorf_run_then_evaluate_on_the_cpu(tmp_path, monkeypatch, cpu_cuts):
    """`--grid_type tensorf`: the run trains and checkpoints a TensoRF k0, and
    `evaluate` takes the grid's backend from the checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert trun.main(["--synthetic", "--tiny", "--cpu", "--grid_type", "tensorf", "--steps", "4", "--superstep",
                      "2", "--i_ckpt", "4", "--i_print", "2", "--n_test", "1"]) == 0
    out = tmp_path / "logs" / "synthetic"
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 4] and all(np.isfinite(r["loss_total"]) for r in rows)
    paths = [e["path"] for e in json.loads(bytes(np.load(out / "last_ckpt.pkl")["__manifest__"]).decode())[
        "sections"]["obj_params"]]
    assert "['k0_grid']['xy_plane']" in paths and "['k0_grid']['f_vec']" in paths
    assert tevaluate.main(["--synthetic", "--cpu", "--n_test", "1", "--res", "32", "--ckpt", str(out / "last_ckpt.pkl"),
                           "--no_test_optim", "--eval_mesh"]) == 0
    res = json.loads((out / "eval" / "synthetic.json").read_text())
    assert res["iteration"] == 4 and np.isfinite(res["psnr"])
    assert (out / "eval" / "chamfer.json").exists()


@pytest.mark.parametrize("source", ["classical", "superglue"])
def test_run_with_a_real_matcher_on_the_synthetic_scene(source, tmp_path, monkeypatch):
    """`--match_source classical|superglue`: the synthetic scene's match
    packs come from the matcher run on its rendered views (SuperGlue with
    seeded random weights, on the CPU as `--cpu` asks), and the run trains on
    them through the PnP chain."""
    from poseprobe_tpu_torch.pose_init import matching, superglue
    from tools.superglue_weights import write
    monkeypatch.chdir(tmp_path)
    flags = ["--match_source", source]
    if source == "superglue":
        write(str(tmp_path / "w"))
        monkeypatch.setenv(matching.SUPERGLUE_WEIGHTS_ENV, str(tmp_path / "w"))
        flags += ["--matcher", "superglue"]
    seen = []
    match = matching.match_pair
    monkeypatch.setattr(matching, "match_pair", lambda *a, **k: seen.append((a[4], k.get("device", a[5:6])))
                        or match(*a, **k))
    sg, packs = superglue.match_pair_superglue, []
    monkeypatch.setattr(superglue, "match_pair_superglue", lambda *a, **k: seen.append(("network", k["device"]))
                        or packs.append(sg(*a, **k)) or packs[-1])
    assert trun.main(["--synthetic", "--tiny", "--cpu", "--steps", "2", "--i_print", "1", "--n_test", "1"]
                     + flags) == 0
    rows = [json.loads(line) for line in (tmp_path / "logs" / "synthetic" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss_total"]) for r in rows)
    assert seen and {b for b, _ in seen if b != "network"} == {"classical" if source == "classical" else "superglue"}
    assert (("network", "cpu") in seen) == (source == "superglue")
    # every SuperGlue pack (object and scene for 3 pairs, one skip pair) holds
    # matches at the published 0.2 threshold
    assert len(packs) == (7 if source == "superglue" else 0) and all((p[:, 4] > 0).any() for p in packs)


def test_evaluate_reads_a_jax_checkpoint(tmp_path, monkeypatch, cpu_cuts):
    """The JAX trainer at the synthetic config (its PnP seeding off, which no
    saved leaf depends on), its state saved by the JAX package, evaluated by
    the port's CLI at the same config."""
    import run as jrun
    from poseprobe_tpu.data.synthetic import make_synthetic_scene
    from poseprobe_tpu.train import state as jstate
    from poseprobe_tpu.train.trainer import JointTrainer as JJointTrainer

    jcfg = jrun.load_config(argparse.Namespace(synthetic=True, config="", datadir="", scene=""))
    jcfg = dataclasses.replace(jcfg, pnp=dataclasses.replace(jcfg.pnp, use_pnp=False))
    jt = JJointTrainer(jcfg, make_synthetic_scene(H=32, W=32, n_test=1))
    jt.state.step = 5
    ckpt = tmp_path / "jax_ckpt.pkl"
    jstate.save_checkpoint(str(ckpt), jt.state, configs={"expname": "synthetic"}, extras=jt.host_extras())
    monkeypatch.chdir(tmp_path)
    assert tevaluate.main(["--synthetic", "--cpu", "--n_test", "1", "--res", "32", "--ckpt", str(ckpt),
                           "--no_test_optim", "--out_dir", str(tmp_path / "ev")]) == 0
    res = json.loads((tmp_path / "ev" / "synthetic.json").read_text())
    assert res["iteration"] == 5 and np.isfinite(res["psnr"])


def _flags(path: Path) -> set:
    return set(re.findall(r'add_argument\(\s*"(--\w+)"', path.read_text()))


@pytest.mark.parametrize("ref,parser", [("run.py", trun.build_parser), ("eval.py", tevaluate.build_parser)])
def test_every_reference_flag_is_accepted(ref, parser):
    ours = {s for a in parser()._actions for s in a.option_strings if s.startswith("--")}
    theirs = _flags(ROOT / ref)
    assert len(theirs) > 10 and theirs <= ours, theirs - ours


def test_flags_make_the_reference_config():
    """Every override flag of `run.py`, given at once: the port's config
    equals the reference's, field for field."""
    import run as jrun
    argv = ["--synthetic", "--steps", "300", "--schedule_steps", "600", "--seed", "3", "--shell_weight", "1.0",
            "--shell_margin", "0.05", "--object_iters", "90", "--maskcache", "--pose_window", "0.4",
            "--fine_start", "0.2", "--pose_trans_window", "0.6", "--matmul_dtype", "bfloat16", "--expname", "e",
            "--no_probe_check", "--beta_cap", "2.0", "--pnp_anchor", "scene", "--reregister", "0.3",
            "--pose_ba", "0.25,0.45", "--pose_warmup", "5", "--warmup_gate", "2.0", "--warmup_photo_ratio", "4",
            "--warmup_holdout", "2", "--warmup_rot_only", "--warmup_center_anchor", "1.0", "--warmup_rescue", "10",
            "--pg_scale", "100,200", "--incremental_step", "50", "--pose_noise", "0.1", "--loss_weight",
            "depth_cons=-2", "--loss_weight", "corres=none", "--dc_start", "0.35", "--fg_fraction", "0.5", "--tiny"]
    targs = trun.build_parser().parse_args(argv)
    ours = trun.apply_overrides(trun.load_config(targs), targs)
    monkey = pytest.MonkeyPatch()
    monkey.setattr("sys.argv", ["run.py"] + argv)
    jargs = jrun.parse_args()
    monkey.undo()
    jcfg = jrun.apply_steps_override(jrun.load_config(jargs), jargs)
    # the reference applies the rest inline in main(); replay it up to the data load
    src = (ROOT / "run.py").read_text()
    body = src[src.index("    if args.seed is not None:"):src.index("    import numpy as np\n\n    from poseprobe_tpu.core")]
    scope = {"dataclasses": dataclasses}
    exec(compile("def _apply(args, cfg):\n" + body + "    return cfg\n", "run.py", "exec"), scope)
    theirs = scope["_apply"](jargs, jcfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_a_port_preset_loads_by_its_path(tmp_path):
    path = ROOT / "poseprobe_tpu_torch" / "config" / "presets" / "dtu_generic.py"
    ns = argparse.Namespace(synthetic=False, config=str(path), datadir="/data/DTU/scan9", scene="")
    assert trun.load_config(ns) == dtu_generic.get_config(datadir="/data/DTU/scan9")
    copy = tmp_path / "my_preset.py"
    shutil.copy(path, copy)
    assert trun.load_config(argparse.Namespace(**{**vars(ns), "config": str(copy)})) == \
        dtu_generic.get_config(datadir="/data/DTU/scan9")
    family = argparse.Namespace(synthetic=False, config=str(path.with_name("dtu_scan.py")), datadir="", scene="30")
    assert trun.load_config(family) == dtu_scan.get_config(scan_id=30)
    plain = path.with_name("dtu_scan1.py")
    assert trun.load_config(argparse.Namespace(**{**vars(ns), "config": str(plain)})) == \
        dtu_scan1.get_config(datadir="/data/DTU/scan9")
    with pytest.raises(SystemExit):
        trun.load_config(argparse.Namespace(**{**vars(ns), "config": str(plain), "scene": "3"}))


@pytest.mark.parametrize("flags,item", [(["--matcher", "superglue"], "matchers"),
                                        (["--grid_type", "tensorf"], "TensoRF"),
                                        (["--match_source", "classical"], "matchers")])
def test_unported_options_raise(flags, item, tmp_path, monkeypatch):
    """The options that raised before they were ported (the name is kept from
    then) now reach what they select: the loader's matcher, the object
    config's grid, the synthetic scene's match source.
    `test_run_with_a_real_matcher_on_the_synthetic_scene` and
    `test_tensorf_run_then_evaluate_on_the_cpu` run them."""
    monkeypatch.chdir(tmp_path)
    args = trun.build_parser().parse_args(["--synthetic", "--cpu"] + flags)
    cfg = trun.apply_overrides(trun.load_config(args), args)
    kw = trun.synthetic_loader_kwargs(cfg, args, run=True)
    got = {"matchers": (args.matcher, kw.get("match_source", "analytic")), "TensoRF": cfg.object_model.grid_type}
    want = {("--matcher", "matchers"): ("superglue", "analytic"), ("--match_source", "matchers"): ("auto", "classical"),
            ("--grid_type", "TensoRF"): "tensorf"}
    assert got[item] == want[(flags[0], item)]


def test_the_clis_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        trun.main(["--synthetic", "--tiny"])
    with pytest.raises(RuntimeError, match="--cpu"):
        tevaluate.main(["--synthetic", "--ckpt", str(tmp_path / "none.pkl")])
    assert not os.path.exists(tmp_path / "logs")
