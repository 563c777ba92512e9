"""The production-mesh dry run (``launch/dryrun.py``) for every arch at
reduced size on a (2, 2, 2) fake mesh (a fake process group of 8 ranks,
fake tensors): a train and a decode cell each, status OK, every roofline
term finite, collectives issued, no process group left open.
"""
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun

torch.set_num_threads(1)

SMALL = {"train": ShapeSpec("train_4k", 32, 8, "train"),
         "decode": ShapeSpec("decode_32k", 32, 8, "decode")}


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_every_arch_reduced_on_a_fake_mesh(arch, kind):
    res = dryrun.run_cell(arch, SMALL[kind].name, cfg=get_config(arch, reduced=True),
                          shape=SMALL[kind], mesh_shape=(2, 2, 2), verbose=False)
    assert res["status"] == "OK" and res["chips"] == 8 and res["mesh"] == "2x2x2"
    t = res["roofline"]
    for k in ("flops_per_device", "bytes_per_device", "compute_s", "memory_s",
              "collective_s", "bound_s", "useful_flops_ratio", "roofline_fraction"):
        assert math.isfinite(t[k]) and t[k] >= 0, k
    assert t["flops_per_device"] > 0 and t["bytes_per_device"] > 0
    assert t["collective_bytes_per_device"] > 0      # a (2, 2, 2) mesh communicates
    assert res["memory"]["argument_bytes_per_device"] > 0
    assert not dist.is_initialized()


