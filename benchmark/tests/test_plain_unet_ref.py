"""The plain reference against the program at a tiny size on the CPU: the
U-Net forward in eval and train mode (BatchNorm's running statistics too),
a few epochs of one lane's training, and one winner forward."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import reference, workload
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.train.engine import TrainSettings, predict, train_fold

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2 ** 31 + 12345


def tiny_inputs(name="tiny"):
    with open(os.path.join(HERE, "tiny", "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    return cfg, workload.make_inputs(cfg, SEED, "cpu")


def port_unet(trial, init, backend):
    m = UNet(UNetConfig(filters=trial.filters, n_blocks=trial.n_blocks,
                        ct_kernel=trial.ct_kernel, conv_backend=backend),
             1, generator=torch.Generator(), device="cpu")
    m.load_state_dict(init)
    return m


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("ct", [(2, 2), (3, 3), (5, 5)])
def test_forward_matches_the_program(backend, ct):
    trial = workload.Trial(0, 16, 1e-3, ct, 2, 2)
    init = workload.lane_init(reference.unet_spec(trial), SEED, 0, 1, 0,
                              "cpu")
    model = port_unet(trial, init, backend)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((6, 16, 16, 1), generator=g) * 10
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    want = reference.forward(trial, init, x, False)
    torch.testing.assert_close(model(x, train=False), want, rtol=1e-5,
                               atol=1e-6)
    updates = {}
    want = reference.forward(trial, init, x, True, w, updates)
    got = model(x, train=True, sample_weight=w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    state = model.state_dict()
    assert updates and set(updates) <= set(state)
    for k, v in updates.items():
        torch.testing.assert_close(state[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lr", [1e-3, 1e-4])
def test_training_and_winner_forward_match_the_program(lr):
    cfg, inp = tiny_inputs()
    trial = workload.Trial(0, 16, lr, (3, 3), 2, 2)
    fold, epochs = 1, 3
    init = workload.lane_init(reference.unet_spec(trial), SEED, 0, fold, 0,
                              "cpu")
    orders = workload.lane_orders(SEED, 0, fold, 0, epochs, len(inp.x))
    settings = TrainSettings(epochs=epochs, batch_size=16, patience=epochs,
                             val_rows=int(inp.val.sum(1).max()),
                             early_exit=True)
    model = port_unet(trial, init, "kernel")
    best, vloss, hist = train_fold(
        model, inp.x, inp.y_onehot[fold], inp.train[fold], inp.val[fold], lr,
        torch.Generator(), settings, init_variables=init,
        epoch_perms=orders)
    v_ref, s_ref, h_ref = reference.train_lane(
        trial, inp.x, inp.y_onehot[fold], inp.train[fold], inp.val[fold],
        init, orders, epochs, epochs)
    np.testing.assert_allclose(hist.numpy(), h_ref, rtol=2e-6)
    assert abs(float(vloss) - v_ref) <= 2e-6 * v_ref
    # weights whose gradient is nought (a conv bias ahead of BatchNorm)
    # move by round-off under Adam; the rest agree
    for k, v in s_ref.items():
        torch.testing.assert_close(best[k], v, rtol=1e-3, atol=2e-5)
    got = predict(model, best, inp.x)
    want = reference.predict(trial, s_ref, inp.x)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(predict(model, best, inp.x),
                               reference.predict(trial, best, inp.x),
                               rtol=0, atol=1e-6)


def test_fold_winner_takes_the_first_least():
    assert reference.fold_winner([1.0, 0.5, 0.5]) == 1
    assert reference.fold_winner([0.2, 0.5]) == 0
    assert reference.fold_winner([float("nan"), 0.5]) == 0
