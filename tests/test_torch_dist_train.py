"""``Trainer(mesh=...)`` on four ranks against the reference's ``Trainer``
on a four-device mesh, on the CPU.

The port runs four processes over gloo on a (2 data x 2 model) DeviceMesh
(``make_mesh_for(4, model_parallel=2)``); the reference runs its trainer
on ``make_mesh_for(4, model_parallel=2)`` in a subprocess with four host
devices (``XLA_FLAGS``: its test process has one).  Both start from the
reference's step-0 state, carried across by its checkpoint, which the
port restores into DTensors (each rank its own shards), and take two
steps on the same stream: reduced granite-moe (expert parallelism over
'model', the capacity of a data shard's tokens) and reduced phi4-mini.
Losses, grad norms and every parameter are held at TOL32.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite_moe_1b", "phi4_mini_3p8b")
STEPS = 2
DATA = dict(batch=4, seq_len=16, seed=2)
#: float32 end to end: the two packages sum in other orders
TOL32 = dict(rtol=1e-4, atol=1e-5)

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh_for
from repro.training import TrainConfig, Trainer
from repro.training.checkpoint import CheckpointManager
from repro.training.data import DataConfig, synthetic_stream

out, steps, data = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
for arch in sys.argv[4:]:
    cfg = get_config(arch, reduced=True)
    t = Trainer(cfg, TrainConfig(steps=steps, log_every=1),
                mesh=make_mesh_for(4, model_parallel=2), seed=0)
    CheckpointManager(os.path.join(out, arch, "ckpt")).save(
        0, {"params": t.params, "opt_state": t.opt_state, "step": 0})
    res = t.fit(synthetic_stream(cfg, DataConfig(**data)))
    flat = {}
    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(tree[k], np.float32)
    walk(t.params, "")
    np.savez(os.path.join(out, arch, "ref.npz"), **flat)
    with open(os.path.join(out, arch, "ref.json"), "w") as f:
        json.dump(res["history"], f)
"""

PORT = r"""
import json, os, sys
import torch
import torch.distributed as dist
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import moe
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.data import DataConfig, synthetic_stream

torch.set_num_threads(1)
rank, port = int(os.environ["RANK"]), os.environ["PORT"]
out, steps, data = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
try:
    mesh = make_mesh_for(4, model_parallel=2)
    caps, orig = [], moe.dispatch
    def dispatch(ids, n, cf, e_base=0, e_local=0):
        res = orig(ids, n, cf, e_base, e_local)
        caps.append([int(ids.shape[0]), res[0]])
        return res
    moe.dispatch = dispatch
    for arch in sys.argv[4:]:
        caps.clear()
        cfg = get_config(arch, reduced=True)
        t = Trainer(cfg, TrainConfig(steps=steps, log_every=1,
                                     checkpoint_dir=os.path.join(out, arch, "ckpt"),
                                     checkpoint_every=1000), mesh=mesh, device="cpu")
        assert t.restore_if_available()
        res = t.fit(synthetic_stream(cfg, DataConfig(**data), device="cpu"))
        state = t.state()
        if rank == 0:
            flat = {}
            def walk(tree, prefix):
                for k in sorted(tree):
                    if isinstance(tree[k], dict):
                        walk(tree[k], prefix + k + "/")
                    else:
                        flat[prefix + k] = tree[k].detach().float().numpy()
            walk(state["params"], "")
            np.savez(os.path.join(out, arch, "port.npz"), **flat)
            place = {k: str(v.placements) for k, v in t.params["layers"]["moe"].items()} \
                if "moe" in t.params.get("layers", {}) else {}
            with open(os.path.join(out, arch, "port.json"), "w") as f:
                json.dump({"history": res["history"], "caps": caps, "moe": place}, f)
        dist.barrier()
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    args = [out, str(STEPS), json.dumps(DATA), *ARCHS]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", REFERENCE, *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", PORT, *args], cwd=ROOT,
                              env=dict(env, RANK=str(r), PORT=port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        errs.append((p.returncode, err))
    assert all(rc == 0 for rc, _ in errs), "\n".join(e[-3000:] for rc, e in errs if rc)
    res = {}
    for arch in ARCHS:
        d = os.path.join(out, arch)
        with open(os.path.join(d, "ref.json")) as f:
            ref_hist = json.load(f)
        with open(os.path.join(d, "port.json")) as f:
            port = json.load(f)
        res[arch] = dict(ref=ref_hist, port=port, ref_p=dict(np.load(os.path.join(d, "ref.npz"))),
                         port_p=dict(np.load(os.path.join(d, "port.npz"))))
    return res


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_grad_norms_match_reference_mesh(runs, arch):
    r = runs[arch]
    assert len(r["port"]["history"]) == len(r["ref"]) == STEPS
    for a, b in zip(r["port"]["history"], r["ref"]):
        np.testing.assert_allclose(a["loss"], b["loss"], **TOL32)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], **TOL32)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_match_reference_mesh(runs, arch):
    r = runs[arch]
    assert sorted(r["port_p"]) == sorted(r["ref_p"])
    for name, want in r["ref_p"].items():
        np.testing.assert_allclose(r["port_p"][name], want, **TOL32, err_msg=name)


def test_moe_capacity_counts_the_local_token_shard(runs):
    """Inside the reference's ``shard_map`` the tokens are the data shard's:
    T = batch/2 * seq, and the capacity follows, not the one-device T."""
    from repro_torch.configs import get_config

    cfg = get_config("granite_moe_1b", reduced=True)
    k, e, cf = cfg.experts_per_token, cfg.num_experts, cfg.moe_capacity_factor
    t_local = DATA["batch"] // 2 * DATA["seq_len"]
    t_global = DATA["batch"] * DATA["seq_len"]
    want = max(8, int(cf * k * t_local / e))
    assert want != max(8, int(cf * k * t_global / e))
    caps = runs["granite_moe_1b"]["port"]["caps"]
    # every MoE layer of every step, forward and remat recompute
    assert caps and all(c == [t_local, want] for c in caps), caps
    # the experts are split over 'model', FSDP off: (model, -, -)
    place = runs["granite_moe_1b"]["port"]["moe"]
    assert place["wg"] == place["wu"] == place["wd"] == "(Replicate(), Shard(dim=1))"
