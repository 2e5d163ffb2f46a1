"""No module the harness loads is JAX's or the JAX package's, and the reference
loads nothing of the program."""
import subprocess
import sys

from portbench import run as run_mod

ROOT = str(__import__("pathlib").Path(__file__).resolve().parents[2])


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(' '.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_top_level_names_are_compared_whole():
    assert run_mod.forbidden_modules({"poseprobe_tpu_torch", "poseprobe_tpu_torch.ops", "jaxtyping"}) == []
    assert run_mod.forbidden_modules({"poseprobe_tpu.ops", "jax.numpy", "flax"}) == ["flax", "jax", "poseprobe_tpu"]


def test_the_harness_loads_no_jax():
    mods = _loaded(
        "import portbench.run, portbench.control\n"
        "from portbench import manifest\n"
        "b = manifest.benchmark()\n"
        "[manifest.driver(manifest.workload(c['name'])['driver']) for c in b['workloads']]\n"
        "[manifest.reader(m['name']) for m in b['per_layer']]\n"
        "import poseprobe_tpu_torch.train.trainer, poseprobe_tpu_torch.eval.evaluator\n")
    assert run_mod.forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import portbench.reference.step, portbench.reference.render, portbench.reference.compare\n")
    assert not {m.split(".")[0] for m in mods} & {"poseprobe_tpu_torch", "poseprobe_tpu", "jax"}
