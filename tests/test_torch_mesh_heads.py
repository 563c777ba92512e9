"""Attention's heads over 'model' where the axis does not divide the
key/value heads, on the CPU.

GSPMD splits the reference's plain attention by query head whatever the
key/value head count; the port splits the query heads over 'model' and
hands each rank the key/value heads its query heads read (padding the
query heads to a multiple of the axis where it does not divide them).

- The dry run's per-device flops of a reduced train cell on a 1 x 4 and a
  1 x 8 fake mesh are held against the reference's loop-weighted HLO
  flops (``weighted_costs``) of the same step compiled on a mesh of that
  shape, in a subprocess with that many host devices (its test process
  has one).  Reduced phi4-mini and granite-moe have 4 query and 2
  key/value heads: on 4 ranks each gets one query head; on 8 the query
  heads are padded to 8.
- On four gloo ranks (``1 x 4``, so rank 1-3 read other key/value heads
  than rank 0), attention's forward and gradients and a float32 prefill
  plus decode step of reduced archs equal the one-process call.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")

#: port / reference per-device flops, read on this test's cells: phi4-mini
#: 1.0093 (1 x 4) and 1.430 (1 x 8, four query heads padded to eight where
#: GSPMD splits them without padding); granite-moe 1.0522 (1 x 4, the
#: dispatch's one-hot products).  Each band excludes the replicated
#: attention the port ran before its heads split (2.51, 4.27 and 2.66).
FLOPS_RATIO = {
    ("phi4_mini_3p8b", 4): (1.00, 1.08),
    ("granite_moe_1b", 4): (1.00, 1.08),
    ("phi4_mini_3p8b", 8): (1.35, 1.50),
}
SEQ, BATCH = 256, 4

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[4]
import jax
import jax.numpy as jnp
jax.devices()   # fixes the device count before the dry run's module sets its own
from jax.sharding import PartitionSpec as P
from repro.analysis.costs import weighted_costs
from repro.configs import get_config
from repro.distribution.sharding import batch_specs, param_specs
from repro.launch import dryrun
from repro.launch.mesh import make_mesh_for
from repro.models import LM, init_params
from repro.training.optimizer import AdamWConfig, adamw_init, adamw_update

arch, seq, batch, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
cfg = get_config(arch, reduced=True)
mesh = make_mesh_for(n, model_parallel=n)
model = LM(cfg)
params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
opt = jax.eval_shape(lambda: adamw_init(params, "float32"))
b = {k: jax.ShapeDtypeStruct((batch, seq), jnp.int32) for k in ("tokens", "labels")}
with jax.set_mesh(mesh):
    ps = param_specs(cfg, params, fsdp=True)

    def step(p, o, bb):
        loss, g = jax.value_and_grad(model.loss)(p, bb)
        return adamw_update(AdamWConfig(), p, g, o)

    sh = (dryrun._shardings(mesh, ps, params),
          dryrun._shardings(mesh, {"m": ps, "v": ps, "step": P()}, opt),
          dryrun._shardings(mesh, batch_specs(cfg, b), b))
    text = jax.jit(step, in_shardings=sh).lower(params, opt, b).compile().as_text()
print(json.dumps(weighted_costs(text)["flops"]))
"""


@pytest.mark.parametrize("arch, n", list(FLOPS_RATIO))
def test_train_cell_flops_per_device_against_reference_mesh(arch, n):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    ref = subprocess.run([sys.executable, "-c", REFERENCE, arch, str(SEQ), str(BATCH), str(n)],
                         env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    res = dryrun.run_cell(arch, "train_4k", shape=ShapeSpec("train_4k", SEQ, BATCH, "train"),
                          mesh_shape=(1, n), cfg=get_config(arch, reduced=True), verbose=False)
    assert res["status"] == "OK"
    ratio = res["roofline"]["flops_per_device"] / want
    lo, hi = FLOPS_RATIO[(arch, n)]
    assert lo <= ratio <= hi, ratio


RANKS = r"""
import dataclasses, os, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.distribution.sharding import cache_specs, param_specs, to_placements
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import LM, init_params
from repro_torch.training.optimizer import _tree_map

torch.set_num_threads(1)
rank, what = int(os.environ["RANK"]), sys.argv[1]
dist.init_process_group("gloo", init_method="tcp://localhost:" + os.environ["PORT"],
                        rank=rank, world_size=4)
mesh = make_mesh_for(4, model_parallel=4)
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
errs = []
try:
    if what == "attention":
        # (query heads, key/value heads): split, split with one kv head,
        # padded (6 and 3 over 4), fewer query heads than ranks
        for hq, hkv in ((4, 2), (4, 1), (8, 2), (6, 2), (6, 3), (3, 1), (12, 4)):
            g = torch.Generator().manual_seed(10 * hq + hkv)
            q, do = (torch.randn(2, hq, 8, 16, generator=g) for _ in range(2))
            k, v = (torch.randn(2, hkv, 8, 16, generator=g) for _ in range(2))
            want = ops.flash_attention(q, k, v, causal=True)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ops.flash_attention_grad(*leaves, causal=True).backward(do)
            dq, dk, dv = (distribute_tensor(t, mesh, [Replicate(), Replicate()])
                          .requires_grad_(True) for t in (q, k, v))
            out = ops.flash_attention(dq.detach(), dk.detach(), dv.detach(), causal=True)
            errs.append((full(out) - want).abs().max().item())
            o2 = ops.flash_attention_grad(dq, dk, dv, causal=True)
            errs.append((full(o2) - want).abs().max().item())
            o2.backward(distribute_tensor(do, mesh, list(o2.placements)))
            errs += [(a.grad.full_tensor() - b.grad).abs().max().item()
                     for a, b in zip((dq, dk, dv), leaves)]
    else:
        cfg = get_config(what, reduced=True)
        if len(sys.argv) > 2:
            cfg = dataclasses.replace(cfg, num_heads=int(sys.argv[2]))
        cfg = dataclasses.replace(cfg, dtype="float32")
        model = LM(cfg)
        params = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        b, l, m = 2, 12, 24
        toks = torch.randint(0, cfg.vocab_size, (b, l), generator=torch.Generator().manual_seed(1))
        nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=torch.Generator().manual_seed(2))
        place = lambda t, s: distribute_tensor(t, mesh, to_placements(s, mesh, t.shape))
        with torch.no_grad():
            cache = model.init_cache(b, m, device="cpu")
            specs = cache_specs(cfg, cache, batch_shardable=True, model_size=4)
            dcache = {k: place(v.clone(), specs[k]) for k, v in cache.items()}
            want0, cache = model.prefill(params, {"tokens": toks}, cache)
            want1, cache = model.decode_step(params, {"tokens": nxt}, cache, l)
            dp = _tree_map(place, params, param_specs(cfg, params, fsdp=False))
            with implicit_replication():
                got0, dcache = model.prefill(dp, {"tokens": place(toks, (("data",), None))},
                                             dcache)
                got1, dcache = model.decode_step(
                    dp, {"tokens": place(nxt, (("data",), None))}, dcache, l)
        errs += [(full(got0) - want0).abs().max().item(),
                 (full(got1) - want1).abs().max().item()]
        errs += [(full(dcache[k]) - cache[k]).abs().max().item() for k in cache]
    print("MAXERR", max(errs))
finally:
    dist.destroy_process_group()
"""

#: float32; the mesh sums the gradients of keys and values over ranks
TOL = 1e-5


def _on_four_ranks(*args):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, *args], cwd=ROOT,
                              env=dict(ENV, RANK=str(r), PORT=port), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    assert all(rc == 0 for _, _, rc in outs), "\n".join(e[-3000:] for _, e, rc in outs if rc)
    return [float(o.split("MAXERR")[-1]) for o, _, _ in outs]


def test_attention_heads_split_on_four_ranks_equal_one_process():
    assert max(_on_four_ranks("attention")) <= TOL


@pytest.mark.parametrize("arch, heads", [("phi4_mini_3p8b", None), ("phi4_mini_3p8b", 6),
                                         ("recurrentgemma_9b", None), ("gemma3_4b", None),
                                         ("granite_moe_1b", None)])
def test_prefill_and_decode_on_four_ranks_equal_one_process(arch, heads):
    """Reduced archs (4 query heads; 6 padded to 8) on a 1 x 4 mesh: the
    caches sharded by ``cache_specs`` (their sequence over 'model' where
    the key/value heads do not divide it, recurrentgemma's ring too)."""
    args = (arch,) if heads is None else (arch, str(heads))
    assert max(_on_four_ranks(*args)) <= TOL
