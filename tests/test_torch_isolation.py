"""The port stands alone: every ``repro_torch`` module and ``chip_smoke``
import with JAX made unimportable, and none of them loads ``repro``."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any 'import jax' now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" and sys.modules[m] is not None)
print(",".join(names), leaked)
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    names, leaked = proc.stdout.split(" ", 1)
    names = names.split(",")
    assert len(names) >= 16
    for mod in ("kernels.flash_attention", "kernels.paged_attention",
                "kernels.alu_chain", "kernels.pointer_chase",
                "kernels.mxu_probe", "kernels.ref", "kernels.ops",
                "models.transformer", "serve.engine", "launch.serve",
                "core.microbench.harness", "core.microbench.memory",
                "core.microbench.mxu", "core.microbench.tables",
                "core.campaign.spec", "core.campaign.results",
                "core.campaign.runner", "core.campaign.registry",
                "core.campaign.report", "core.campaign.cli",
                "core.campaign.__main__", "kernels.wkv6", "kernels.ssm_scan",
                "models.layers.rwkv", "models.layers.mamba",
                "data.synthetic", "train.step", "core.perfmodel.hardware",
                "core.costmodel.calibration", "core.costmodel.instruction",
                "core.costmodel.memory", "core.costmodel.mxu",
                "core.costmodel.model", "core.costmodel.analytic",
                "core.costmodel.cli", "core.costmodel.__main__",
                "core.isa", "core.isa.sass_census", "core.autotune",
                "core.autotune.cache", "core.autotune.space",
                "core.autotune.search", "core.autotune.cli",
                "core.autotune.__main__", "serve.sim", "serve.telemetry",
                "serve.telemetry.metrics", "serve.telemetry.drift",
                "serve.telemetry.slo", "serve.telemetry.control",
                "serve.telemetry.recalibrate", "serve.telemetry.scenarios",
                "serve.telemetry.cli", "serve.telemetry.__main__"):
        assert f"repro_torch.{mod}" in names
    assert leaked.strip() == "[]"


def test_port_sources_name_no_jax_or_repro():
    """No import of jax or of the reference package in the port's sources
    or in chip_smoke.py."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    path, line)


def test_build_model_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build_model
    with pytest.raises(RuntimeError):
        build_model(reduced(ARCHS["gemma2-2b"]))


def test_chip_smoke_refuses_to_run_without_cuda():
    """No card: non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
