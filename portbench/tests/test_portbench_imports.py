"""What a run may load, and what the reference may import."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.harness import manifest, runner

HERE = manifest.ROOT / "portbench"


def test_jax_and_the_jax_package_are_found_by_whole_top_level_name():
    assert runner.forbidden_modules({"jax": 0, "jax.numpy": 0, "numpy": 0}) == ["jax"]
    assert runner.forbidden_modules({"mpreid_tpu.models": 0}) == ["mpreid_tpu"]
    assert runner.forbidden_modules({"flax.linen": 0, "optax": 0, "jaxlib.xla": 0}) == \
        ["flax", "jaxlib", "optax"]
    assert runner.forbidden_modules({"mpreid_tpu_torch": 0, "mpreid_tpu_torch.ops": 0,
                                     "jaxtyping": 0}) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    for path in (HERE / "reference").glob("*.py"):
        bad = set(_imports(path)) & {"mpreid_tpu_torch", "mpreid_tpu", "jax", "jaxlib", "flax",
                                     "optax", "portbench"}
        assert not bad, (path.name, bad)


def test_the_harness_imports_no_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & {"mpreid_tpu", "jax", "jaxlib", "flax", "optax"}, path


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "vitb16-uniprompt.stage2a", "--seed", "1", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = _run(manifest.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
