"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the references import nothing of the program."""

import ast
import subprocess
import sys

from portbench import run as prun

FORBIDDEN = {"jax", "jaxlib", "flax", "shermbot_navigation_tpu"}

PROBE = """
import contextlib, glob, importlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
from portbench import run as prun
from portbench.drivers import batch_lanes, serving
for m in prun.manifest()["per_layer"]:
    prun.reader(m["name"])
_, cfg, mix = prun.cell_spec(prun.manifest(), "lidar20.wide50")
c = batch_lanes.Cell(cfg, dict(mix, batch=2, episode_ticks=2, warmup_ticks=1,
                               checked_worlds=1), 1, torch.device("cpu"))
c.window(0.0, lambda n: contextlib.nullcontext())
c.check()
_, cfg, mix = prun.cell_spec(prun.manifest(), "serve50k.known")
s = serving.Cell(dict(cfg, landmarks=64), dict(mix, warmup_ticks=2,
                 checked_rows_seen=1, checked_rows_unseen=1,
                 session_ticks=3), 1,
                 torch.device("cpu"))
s.window(0.0, lambda n: contextlib.nullcontext())
s.check()
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", PROBE, str(prun.ROOT)],
                       capture_output=True, text=True, cwd=prun.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "shermbot_navigation_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_check_names_whole_modules():
    assert "shermbot_navigation_tpu_torch" not in FORBIDDEN
    sys.modules.setdefault("jaxlib_lookalike", sys)
    try:
        assert "jaxlib_lookalike" not in prun.loaded_forbidden()
    finally:
        del sys.modules["jaxlib_lookalike"]


def test_references_import_nothing_of_the_program():
    for path in (prun.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"math", "torch", "__future__"}, \
                    (path.name, n)
