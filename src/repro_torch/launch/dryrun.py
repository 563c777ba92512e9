"""Multi-pod dry run: one step of every (arch, shape) cell traced on the
production mesh, without a byte allocated.

Where the reference lowers and compiles each cell with XLA on 512
placeholder CPU devices, the port runs the cell's step in one process
under ``torch.distributed``'s ``"fake"`` process group of 256 or 512
ranks, on fake tensors (``FakeTensorMode``) on the CPU device: the
parameters, optimizer moments, batch and caches are DTensors on the
(16, 16) or (2, 16, 16) mesh, placed by the reference's rules
(``distribution/sharding.py``, ``_filter_spec``), and the step's
redistributions issue the collectives the mesh needs.  The reference's
dry run lowers the pure-jnp path, not Pallas; the port's goes through
its kernels' plain versions likewise.  It never touches the card: asked
for a CUDA device, it raises.

:class:`~repro_torch.analysis.trace.StepCounter` counts the step's
per-device flops, bytes and collective bytes, and
:func:`~repro_torch.analysis.roofline.roofline_from_trace` turns them
into the three-term roofline on H100 constants.  The result JSON keeps
the reference's keys: ``lower_s`` is the set-up (fake inputs placed),
``compile_s`` the traced step; ``memory`` holds the per-device bytes of
the arguments (the other entries of XLA's memory analysis have no
counterpart here and are None).

    python -m repro_torch.launch.dryrun --arch granite_moe_1b --shape train_4k
    python -m repro_torch.launch.dryrun --both-meshes        # the sweep

Results go to ``build/dryrun_torch/`` (git-ignored), one JSON per cell.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..analysis.roofline import roofline_from_trace
from ..analysis.trace import StepCounter
from ..configs import ARCHS, SHAPES, get_config
from ..configs.shapes import ShapeSpec
from ..distribution.sharding import (  # noqa: F401  (_filter_spec: the reference's name)
    _filter_spec, batch_specs, cache_specs, param_specs, to_placements,
)
from ..models import LM, init_params
from ..models.config import ModelConfig
from ..training.optimizer import AdamWConfig, _tree_map, adamw_init, adamw_update, tree_leaves
from .mesh import make_mesh, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

__all__ = ["input_specs", "run_cell", "main", "fake_world", "RESULTS_DIR"]


# ---------------------------------------------------------------------------
# input specs (shape/dtype stand-ins; no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) stand-ins for every model input of this cell."""
    b, i32 = shape.global_batch, torch.int32
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len
        if cfg.num_codebooks:
            out = {"tokens": ((b, cfg.num_codebooks, s), i32)}
        elif cfg.num_patches:
            out = {"tokens": ((b, s - cfg.num_patches), i32),
                   "patch_embeds": ((b, cfg.num_patches, cfg.d_model), cfg.torch_dtype)}
        else:
            out = {"tokens": ((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = out["tokens"]
        return out
    # decode: one new token
    if cfg.num_codebooks:
        return {"tokens": ((b, cfg.num_codebooks, 1), i32)}
    return {"tokens": ((b, 1), i32)}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake process group; one is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(mesh, spec, full_shape, dtype, requires_grad=False):
    """A fake DTensor of ``full_shape`` placed by ``spec`` (each rank's
    shard cut locally: no communication)."""
    from torch.distributed.tensor import distribute_tensor

    t = torch.empty(full_shape, dtype=dtype)
    out = distribute_tensor(t, mesh, to_placements(spec, mesh, full_shape), src_data_rank=None)
    return out.requires_grad_(True) if requires_grad else out


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _trace(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Place the cell's fake inputs on ``mesh`` and run its step under a
    :class:`StepCounter`: (counter, argument bytes per device, set-up s,
    step s)."""
    model_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    model = LM(cfg)
    t0 = time.time()
    meta = init_params(cfg, device="meta")
    fsdp_serve = cfg.param_count() * 2 > 16 * (16e9) * 0.5  # deepseek-class
    train = shape.kind == "train"
    p_specs = param_specs(cfg, meta, fsdp=True if train else fsdp_serve)
    params = _tree_map(lambda m, s: _placed(mesh, s, m.shape, m.dtype, train), meta, p_specs)
    stand = input_specs(cfg, shape)
    b_specs = batch_specs(cfg, {k: torch.empty(sh, device="meta") for k, (sh, _) in stand.items()})
    batch = {k: _placed(mesh, b_specs[k], sh, dt) for k, (sh, dt) in stand.items()}
    args = [params, batch]

    if train:
        # deepseek-class models: bf16 optimizer moments
        state_dtype = "bfloat16" if fsdp_serve else "float32"
        opt = adamw_init(params, state_dtype)
        opt["step"] = 0
        acfg = AdamWConfig(state_dtype=state_dtype)
        args.append(opt)

        def step():
            loss = model.loss(params, batch)
            loss.backward()
            grads = _tree_map(lambda p: p.grad, params)
            return adamw_update(acfg, params, grads, opt)
    else:
        cache_meta = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
        shardable = shape.kind == "prefill" or shape.global_batch >= 32
        c_specs = cache_specs(cfg, cache_meta, batch_shardable=shardable,
                              model_size=model_size)
        cache = {k: _placed(mesh, c_specs[k], v.shape, v.dtype)
                 for k, v in cache_meta.items()}
        args.append(cache)

        def step():
            with torch.no_grad():
                if shape.kind == "prefill":
                    return model.prefill(params, batch, cache)
                return model.decode_step(params, batch, cache, shape.seq_len - 1)

    arg_bytes = sum(_local_bytes(a) for a in args)
    t_lower = time.time() - t0
    with StepCounter() as counter:
        step()
    t_compile = time.time() - t0 - t_lower
    return counter, arg_bytes, t_lower, t_compile


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True, *,
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeSpec] = None,
             mesh_shape: Optional[Sequence[int]] = None, device="cpu") -> dict:
    """One cell: ``arch`` at full width on the production mesh (``cfg``,
    ``shape`` and ``mesh_shape`` override the config, the shape cell and
    the mesh, for reduced runs)."""
    if torch.device(device).type != "cpu":
        raise ValueError(f"the dry run traces on fake CPU tensors, never on {device}")
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {
            "arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "status": "SKIP(full-attention)",
        }
    if mesh_shape is None:
        chips, mesh_name = (512, "pod2x16x16") if multi_pod else (256, "pod16x16")
        build_mesh = lambda: make_production_mesh(multi_pod=multi_pod)  # noqa: E731
    else:
        chips, mesh_name = math.prod(mesh_shape), "x".join(str(n) for n in mesh_shape)
        build_mesh = lambda: make_mesh(mesh_shape)  # noqa: E731

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with fake_world(chips):
        mesh = build_mesh()   # real rank tensors: built outside the fake mode
        with FakeTensorMode(), implicit_replication():
            counter, arg_bytes, t_lower, t_compile = _trace(cfg, shape, mesh)

    terms = roofline_from_trace(arch, shape, mesh_name, chips, counter.counts(), cfg)
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "status": "OK",
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": None,
            "temp_bytes_per_device": None,
            "alias_bytes_per_device": None,
        },
        "collective_ops": counter.counts()["collective_ops"],
        "roofline": terms.to_dict(),
    }
    if verbose:
        print(
            f"[dryrun] {arch:22s} {shape.name:12s} {mesh_name:10s} "
            f"args={arg_bytes / 1e9:6.2f}GB "
            f"compute={terms.compute_s*1e3:8.2f}ms mem={terms.memory_s*1e3:8.2f}ms "
            f"coll={terms.collective_s*1e3:8.2f}ms dom={terms.dominant:10s} "
            f"setup={t_lower:5.1f}s trace={t_compile:6.1f}s",
            flush=True,
        )
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run sweep (fake tensors, CPU)")
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                path = outdir / f"{tag}.json"
                if path.exists() and not args.force:
                    cached = json.loads(path.read_text())
                    if not str(cached.get("status", "")).startswith("FAIL"):
                        print(f"[dryrun] cached {tag}")
                        continue  # retry previous failures
                try:
                    res = run_cell(arch, shape, multi_pod=mp)
                except Exception as e:  # record the failure, keep sweeping
                    res = {
                        "arch": arch, "shape": shape,
                        "mesh": "multi" if mp else "single",
                        "status": f"FAIL: {type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    failures.append(tag)
                    print(f"[dryrun] FAIL {tag}: {e}", flush=True)
                path.write_text(json.dumps(res, indent=2))
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
