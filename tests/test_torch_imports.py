"""The PyTorch port stands alone: no JAX, nothing of the reference
package, and no silent move to the CPU when the card is missing."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_imports_without_jax_or_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.scenarios, repro_torch.core.sim.soa\n"
        "import repro_torch.core.sim.soa_kernels, repro_torch.core.sim.batch\n"
        "import repro_torch._cuda\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    return files


@pytest.mark.parametrize("banned", ["jax", "repro"])
def test_no_import_names_jax_or_reference(banned):
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] != banned, f"{path}:{node.lineno} imports {n}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_without_device_raises_when_cuda_absent(no_cuda):
    from repro_torch.scenarios import ScenarioSpec, get_scenario, run

    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="cyc")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(spec, seeds=[0], backend="soa")
    # fallback=True never routes around a missing card either
    with pytest.raises(RuntimeError, match="CUDA"):
        run(spec, seeds=[0], backend="soa", fallback=True)


def test_device_sampler_and_loop_refuse_missing_cuda(no_cuda):
    from repro_torch._device import resolve_device
    from repro_torch.core.sim import soa_kernels as K

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        K.simulate(None, {}, {"work": None})


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch import _cuda

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.nvcc_path()


@pytest.mark.parametrize(
    "backend, match",
    [("auto", "A3"), ("lockstep", "A3")],
)
def test_unported_backends_name_their_roadmap_item(backend, match):
    from repro_torch.scenarios import ScenarioSpec, get_scenario, run

    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="cyc")
    with pytest.raises(NotImplementedError, match=match):
        run(spec, seeds=[0], backend=backend, device="cpu")


def test_unported_recorders_and_sweeps_raise():
    import dataclasses

    from repro_torch.scenarios import (
        ScenarioSpec, aggregate_sweep, get_scenario, parallel_map, run, sweep,
    )

    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="cyc")
    with pytest.raises(NotImplementedError, match="A7"):
        run(dataclasses.replace(spec, record=True), backend="scalar", device="cpu")
    for fn in (sweep, aggregate_sweep, parallel_map):
        with pytest.raises(NotImplementedError, match="A7"):
            fn(1)
