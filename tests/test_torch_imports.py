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
                "sqmc_tpu_torch.ops.slotpar"):
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
