"""The port never imports jax or the JAX package: the card it runs on has
no jax.  A fresh interpreter with jax blocked imports every module."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "sqmc_tpu_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    for new in ("sqmc_tpu_torch.algo.guiding",
                "sqmc_tpu_torch.systems.hubbard.system",
                "sqmc_tpu_torch.utils.checkpoint",
                "sqmc_tpu_torch.systems.toy",
                "sqmc_tpu_torch.algo.densewalk",
                "sqmc_tpu_torch.systems.hubbard.meanfield",
                "sqmc_tpu_torch.systems.hubbard.vmc",
                "sqmc_tpu_torch.systems.hubbard.cpmc",
                "sqmc_tpu_torch.systems.hubbard.symmetry",
                "sqmc_tpu_torch.systems.hubbard.dmbasis",
                "sqmc_tpu_torch.utils.refio",
                "sqmc_tpu_torch.algo.legacy_ci",
                "sqmc_tpu_torch.algo.rdm",
                "sqmc_tpu_torch.algo.greens",
                "sqmc_tpu_torch.systems.chem.cas",
                "sqmc_tpu_torch.systems.chem.mp2",
                "sqmc_tpu_torch.parallel.dist",
                "sqmc_tpu_torch.parallel.dryrun",
                "sqmc_tpu_torch.systems.chem.synthetic",
                "sqmc_tpu_torch.ops.hbselect",
                "sqmc_tpu_torch.ops.slotpar",
                "sqmc_tpu_torch.ops.spawnhist",
                "sqmc_tpu_torch.ops.ctchain",
                "sqmc_tpu_torch.bench",
                "sqmc_tpu_torch.entry"):
        assert new in mods, new
    code = (
        "import sys\n"
        "for m in [m for m in sys.modules if m.split('.')[0] == 'jax']:\n"
        "    del sys.modules[m]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sqmc_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'sqmc_tpu' or m.startswith('sqmc_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print(len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 54


def test_chip_smoke_and_port_sources_import_no_jax():
    """No import statement of chip_smoke.py or of the port's modules, at
    top level or inside a function, names jax or the JAX package."""
    import ast
    files = [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "sqmc_tpu_torch").rglob("*.py"))
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "sqmc_tpu")]
    assert len(files) >= 56 and not bad, bad
