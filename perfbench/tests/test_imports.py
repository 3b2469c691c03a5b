"""Nothing the benchmark runs imports JAX or the JAX package: a module's
top-level name (before the first dot) is compared whole, since the port's
name, etol_tpu_torch, begins with the JAX package's."""
import ast
import os
import subprocess
import sys

from perfbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("etol_tpu_torch.solve", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"etol_tpu_torch", "jaxtyping", "flaxen"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "etol_tpu.solve", sys)
    assert "etol_tpu" in harness.forbidden_modules()


def test_no_source_of_the_benchmark_imports_them():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                assert not {n.split(".")[0] for n in names} & set(
                    harness.FORBIDDEN), (f, names)


def test_a_whole_run_loads_none_of_them():
    """A run of the MPC cell on the CPU in a fresh process (the program's
    lazy imports included) returns its line: ``run`` returns None where a
    forbidden module is loaded once the window has closed."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness, draws\n"
        "t = dict(draws.load_traffic('mpc_tick'), ticks=1)\n"
        "line = harness.run('ocp2d_mpc_tick', 7, 0.0, False, device='cpu',"
        " traffic=t)\n"
        "print(line is not None, harness.forbidden_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib',"
        " 'flax', 'etol_tpu'}))\n" % os.path.dirname(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=os.path.dirname(HERE))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True [] []"
