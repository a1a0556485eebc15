"""The reference against the port's plain CPU path at toy widths: the same
masks, the same poses, the same training steps."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOY = json.loads((ROOT / "tests" / "data" / "toy.json").read_text())


@pytest.mark.parametrize("rows", [(1, 0), (3, 2)])
def test_dropout_masks_equal_the_ports(rows):
    """The reference's Philox (one int64 multiply per word pair) draws the
    port's masks bit for bit, row map included."""
    from benchmark.reference.ops import dropout as ref
    from fabind_tpu_torch.ops import dropout as port
    x = torch.randn(5, 7, 33)
    seed = torch.tensor(-(2 ** 62) + 12345)
    rnd = torch.tensor(3)
    for site in (0, 2 ** 32 - 1, port.site_id("complex_model")):
        a = ref.dropout_reference(x, seed, rnd, site, 1, 0.1, *rows)
        b = port.dropout_reference(x, seed, rnd, site, 1, 0.1, *rows)
        assert torch.equal(a, b)
    assert ref.host_u32(2 ** 63 + 5, 77) == port.host_u32(2 ** 63 + 5, 77)


def test_reference_poses_equal_the_ports_cpu_path():
    """dock_raw at toy width in float32 on the CPU: the port's engine and
    the reference give the same poses from the same weights."""
    from benchmark import gen
    from benchmark.configs_io import BenchConfig
    from benchmark.reference import dock as ref
    from benchmark.weights import seeded_state_dict
    from fabind_tpu_torch.serve import DockingEngine
    from benchmark.harness import port_config

    c = BenchConfig("toy_fabind", dict(TOY["configs"]["toy_fabind"],
                                       serve_dtype="fp32"))
    raws = gen.make_pool(TOY["traffic"]["toy_batch"], 11)
    sd = seeded_state_dict(c.ref_cfg, 11, "cpu", c.coord_scale)
    cfg, buckets = port_config(c)
    eng = DockingEngine(cfg, state_dict=sd, buckets=buckets, batch_size=2,
                        bf16=False, device="cpu")
    got = [p.coords for p in eng.dock_raw(raws)]
    want = ref.dock_raw(ref.build(c.ref_cfg, sd, "cpu"), raws,
                        c.ref_bucket_cfgs(), 2, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)
