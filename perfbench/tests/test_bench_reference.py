"""The plain reference against dsen2_tpu_torch at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from perfbench import frozen
from perfbench.generators.tile import make_weights, nested
from perfbench.reference import net as refnet
from perfbench.reference import train as reftrain
from perfbench.reference.patches import TileReference, bilinear, sample_ids
from perfbench.tests import tiny

NETS = {"2x": {"in_channels": [4, 6], "num_layers": 1, "feature_size": 16,
               "residual_scale": 0.1, "lr_factor": 2, "patch_size": 128, "border": 8,
               "weights": "seed"},
        "6x": {"in_channels": [4, 6, 2], "num_layers": 1, "feature_size": 16,
               "residual_scale": 0.1, "lr_factor": 6, "patch_size": 192, "border": 12,
               "weights": "seed"}}


@pytest.mark.parametrize("n_in,n_out", [(64, 128), (32, 192), (96, 192), (7, 7)])
def test_bilinear_matches_the_programs_resize(n_in, n_out):
    from dsen2_tpu_torch.ops.resize_weights import bilinear_matrix

    np.testing.assert_allclose(bilinear(n_in, n_out), bilinear_matrix(n_in, n_out), atol=1e-12)


@pytest.mark.parametrize("head,side", [("2x", 240), ("6x", 240), ("2x", 234)])
def test_mosaic_blocks_match_the_api(head, side, monkeypatch):
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer import api

    tiny.patch_presets(monkeypatch)
    net = NETS[head]
    rasters = frozen.synthetic_scene(3, side)
    w = make_weights(net, 9, 0, "cpu")
    icfg = InferConfig(patch_size=net["patch_size"], border=net["border"], precision="highest")
    n_in = len(net["in_channels"])
    run = api.dsen2_20 if head == "2x" else api.dsen2_60
    out = run(*rasters[:n_in], params=nested(w), infer_cfg=icfg, device="cpu")
    ref = TileReference(rasters[:n_in], net, w, "cpu")
    ids = [(i, j) for i in range(ref.rows) for j in range(ref.cols)]
    covered = np.zeros(out.shape[:2], bool)
    # Both compute in float32 with sums in other orders: 1e-5 of the
    # largest DN.
    atol = 1e-5 * float(np.abs(out).max())
    for (i, j), block in zip(ids, ref.blocks(ids)):
        y0, y1, x0, x1 = ref.owned(i, j)
        np.testing.assert_allclose(out[y0:y1, x0:x1], block, rtol=0, atol=atol)
        covered[y0:y1, x0:x1] = True
    assert covered.all()


def test_sample_ids_hold_the_edges():
    ids = sample_ids(5, 7, 4, np.random.default_rng(0))
    assert len(ids) == len(set(ids))
    assert {(0, 0), (0, 6), (4, 0), (4, 6), (3, 6), (4, 5)} <= set(ids)


@pytest.mark.parametrize("rows, cols", [(99, 99), (66, 66), (33, 33), (3, 40)])
def test_sample_ids_meet_every_batch_and_row(rows, cols):
    """Every run of 64 consecutive row-major patches (a batch of the
    engine's, wherever its band starts) and every patch row is sampled."""
    ids = sample_ids(rows, cols, 32, np.random.default_rng(rows))
    flat = np.zeros(rows * cols, bool)
    flat[[i * cols + j for i, j in ids]] = True
    runs = np.convolve(flat, np.ones(64, int), mode="valid")
    assert runs.min() >= 1
    assert {i for i, _ in ids} == set(range(rows))
    assert len(ids) == len(set(ids)) <= 6 + rows + -(-rows * cols // 32)


def test_net_matches_s2net():
    from dsen2_tpu_torch.core.config import ModelConfig
    from dsen2_tpu_torch.models import s2net
    from dsen2_tpu_torch.weights import params_to_torch

    net = dict(NETS["6x"], num_layers=2)
    w = make_weights(net, 4, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    xs = [torch.rand((2, 24, 24, c), generator=g) * 3 for c in net["in_channels"]]
    cfg = ModelConfig(in_channels=(4, 6, 2), num_layers=2, feature_size=16)
    got = s2net.apply(params_to_torch(nested(w), "cpu"), xs, cfg, precision="highest")
    with refnet.no_tf32():
        want = refnet.forward(refnet.to_device(w, "cpu"), [x.permute(0, 3, 1, 2) for x in xs])
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_first_steps_match_fit_steps():
    from dsen2_tpu_torch.core.config import ModelConfig, TrainConfig
    from dsen2_tpu_torch.train import loop
    from dsen2_tpu_torch.weights import params_to_torch

    net = NETS["2x"]
    w = make_weights(net, 4, 0, "cpu")
    xs, label = frozen.training_set(3, 48, 16, net["in_channels"])
    rows = reftrain.batches(7, 48, 16, 3)
    tc = TrainConfig(batch_size=16, seed=7)
    ref = reftrain.first_steps(w, xs, label, rows, net, reftrain.KerasNadam(), "cpu")

    params = {t: {k: v.clone().requires_grad_(True) for k, v in sub.items()}
              for t, sub in params_to_torch(nested(w), "cpu").items()}
    opt = loop.make_optimizer(params, tc)
    cfg = ModelConfig(in_channels=(4, 6), num_layers=1, feature_size=16)
    losses = []
    for r in rows:
        batch = tuple(torch.as_tensor(x[r]) for x in xs)
        loss, _ = loop.train_step(params, opt, batch, torch.as_tensor(label[r]), cfg, "highest")
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5)
    for top, sub in params.items():
        for k, v in sub.items():
            np.testing.assert_allclose(v.detach().numpy(), ref["end"][f"{top}.{k}"].numpy(),
                                       rtol=1e-4, atol=1e-7)
