"""The import rule: nothing the benchmark runs loads JAX, jaxlib, flax or
the JAX package, compared by whole top-level names (the port's name begins
with the JAX package's), and the reference and the yardstick import nothing
of the port."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "treelearn_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compared_whole():
    names = ["treelearn_tpu_torch.model", "treelearn_tpu", "jaxlib.xla",
             "jax_like", "flax"]
    assert [n.split(".")[0] in FORBIDDEN for n in names] == [
        False, True, True, False, True]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, (path, bad)


def test_reference_and_yardstick_import_nothing_of_the_port():
    for sub in ("reference", "yardstick"):
        for path in _sources(sub):
            mods = set(_imports(path))
            assert "treelearn_tpu_torch" not in mods, path
            assert not FORBIDDEN & mods, path


def test_a_cpu_run_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark import run\n"
        "man = run.load_manifest()\n"
        "w = run.read_json(%r)\n"
        "w['plot'].update(n_trees=3, extent=10.0, points_per_tree=800,"
        " ground_points=2000)\n"
        "out = run.run_cell('seg_dbscan_60m', 3, 0.1, False, 'cpu', man,"
        " work=w, log=lambda s: None)\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    ) % (ROOT, os.path.join(BENCH, "workloads", "plot_60m.json"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "seg_dbscan_60m",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
