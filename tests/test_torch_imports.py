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
        "import repro_torch.configs, repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.kernels, repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.ssd, repro_torch.kernels.rglru\n"
        "import repro_torch.models.mamba2, repro_torch.models.rglru\n"
        "import repro_torch.serving, repro_torch.serving.colocated, repro_torch.launch.serve\n"
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


def test_serving_engine_without_device_raises_when_cuda_absent(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine

    cfg = get_config("granite_moe_1b", reduced=True)
    params = init_params(cfg, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "granite_moe_1b"])


#: items the port has carried since these cases were written (B3: mamba2
#: and the SSD kernel, B4: recurrentgemma, the RG-LRU kernel and the ring
#: cache); their cases now hold that the same calls succeed
PORTED_ITEMS = ("B3", "B4")


@pytest.mark.parametrize("arch, item", [
    ("mamba2_2p7b", "B3"), ("recurrentgemma_9b", "B4"), ("deepseek_v2_236b", "A9"),
    ("gemma2_27b", "A9"), ("gemma3_4b", "A9"), ("stablelm_12b", "A9"),
    ("phi3_vision_4p2b", "A9"), ("musicgen_large", "A9"),
])
def test_unported_archs_name_their_roadmap_item(arch, item):
    import dataclasses

    from repro_torch.configs import get_config

    if item in PORTED_ITEMS:
        from repro.configs import get_config as ref_config

        for reduced in (False, True):
            assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
                dataclasses.asdict(ref_config(arch, reduced=reduced))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        get_config(arch)


@pytest.mark.parametrize("op, item", [("ssd_chunked", "B3"), ("rglru_scan", "B4")])
def test_unported_kernels_name_their_roadmap_item(op, item):
    from repro_torch.kernels import ops

    assert item in PORTED_ITEMS
    g = torch.Generator().manual_seed(0)
    if op == "ssd_chunked":
        x = torch.randn(2, 20, 3, 8, generator=g)
        y, state = ops.ssd_chunked(
            x, torch.rand(2, 20, 3, generator=g), -torch.rand(3, generator=g),
            torch.randn(2, 20, 1, 16, generator=g), torch.randn(2, 20, 1, 16, generator=g),
            chunk=8,
        )
        assert y.shape == x.shape and state.shape == (2, 3, 8, 16)
    else:
        x = torch.randn(2, 7, 16, generator=g)
        y, h_last = ops.rglru_scan(x, torch.randn(2, 7, 16, generator=g),
                                   torch.randn(2, 7, 16, generator=g),
                                   torch.randn(16, generator=g), torch.zeros(2, 16))
        assert y.shape == x.shape and torch.equal(h_last, y[:, -1])
    assert bool(torch.isfinite(y).all())


def test_unported_model_branches_name_their_roadmap_item():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    base = get_config("phi4_mini_3p8b", reduced=True)
    for change, item in [
        (dict(family="ssm"), "B3"), (dict(family="hybrid"), "B4"), (dict(mla=True), "A9"),
        (dict(num_codebooks=4), "A9"), (dict(num_patches=16), "A9"),
    ]:
        if item in PORTED_ITEMS:
            assert LM(dataclasses.replace(base, **change)).cfg.family == change["family"]
            continue
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            LM(dataclasses.replace(base, **change))
