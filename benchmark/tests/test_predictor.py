"""The configuration's predictor mode (`data.predictor`) in the input
generator: the 'mean' path hands the bytes it handed before the mode
existed, and 'stacked' hands each member as a row of its own, with the
labels fit over the tiled rows, as the reference's preprocess_stacked does.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark import counts, reference, workload

from .util import run_cell, tiny_args

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")
TINY = os.path.join(HERE, "tiny", "configs")
SEED = 2 ** 31 + 12345

# sha256 of the inputs at SEED on the CPU, computed at commit 88b5ff3, before
# the predictor mode was added: x, y_onehot, train, val of make_inputs
MEAN_INPUTS = {
    "ecmwf_com_32": (
        "6f4036c3afdec8962e23ffd295be27419b2f832c895d665fd841109cdc59c70c",
        "581e085393605729b7ef3d607eac901f1da72345cb3b35a20dd2c39c0aa949b2",
        "75acfc45875ca8ca5d79e3303134d777e6c2fce96159911accf9cd128d013c1e",
        "c8a2457edf70a02dfe9b16e4bc5abee6a81f546e873c4b5e004cd97a970f5bf3"),
    "iitm_full_64": (
        "296569d3fc66f7f3579909d8f57aa46623394ef97c8cce3595047f7f2dfa176f",
        "8098784d39694b22094ebd668b6f9744b29e32567e74ba0277ff01e0a4f3bb00",
        "350c093f7db702240c690aa61d1d56f766ea8112a49b8b46ae222f02d81ad4cc",
        "6d3f7ca1103965b4a03dd5bc70b57ca188ecc9ddeebb44c23bdc80caaee55c39"),
}
# ... and of lane_init (state_dict entries by sorted name) and lane_orders
# (the configuration's epochs x T) of the bucket's last trial at two
# (call, fold) keys
LANE_INPUTS = {
    "ecmwf_com_32": {
        (0, 3): (
            "24ae5134b0da93f5ac5cce827c94613b6d5c28535c245d0780e83a44a8c421c9",
            "c502fbf0b1d51138dfa6546335eae9dd726203ba6ee1c767dc530acfa0840b9a"),
        (-1, 7): (
            "b544638f6a3388a85dd59db26f07b1e728a9ede1f197f4f2a28593530bdd239b",
            "ef4699553357942a59b66168eecc2c0bc66e8546b35685827cd89c80ae38811e")},
    "iitm_full_64": {
        (0, 3): (
            "0939aeeee47edf65eaf04453380542245c03a2f33500d628c219d2a52874b85b",
            "0a22d9d8b8e12f632dece0b8c0781a62017d5a85c063f4ec5fee24702f159cc6"),
        (-1, 7): (
            "351ec76dd013dd286d1621d6817d215573441f303a40d79c5431e785fd450c4d",
            "3c2b2fd72662e808e339ee93ff5e38120c21183394ebfb9971c003c1efc78275")},
}


def load(path, name):
    with open(os.path.join(path, f"{name}.json")) as fh:
        return json.load(fh)


def sha(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(MEAN_INPUTS))
def test_the_mean_inputs_keep_their_bytes(name):
    cfg = load(CONFIGS, name)
    assert "predictor" not in cfg["data"]
    inp = workload.make_inputs(cfg, SEED, "cpu")
    assert inp.predictor == "mean"
    got = tuple(sha(getattr(inp, k)) for k in ("x", "y_onehot", "train",
                                                "val"))
    assert got == MEAN_INPUTS[name]


@pytest.mark.parametrize("name", sorted(LANE_INPUTS))
def test_the_lane_inputs_keep_their_bytes(name):
    cfg = load(CONFIGS, name)
    d = cfg["data"]
    T = len(workload.sample_dates(cfg["years"], d["season"],
                                  d["lead_days"])[0])
    trial = workload.bucket_trials(cfg)[-1]
    spec = reference.unet_spec(trial)
    for (call, fold), (want_init, want_orders) in LANE_INPUTS[name].items():
        init = workload.lane_init(spec, SEED, call, fold, trial.index, "cpu")
        h = hashlib.sha256()
        for k in sorted(init):
            h.update(k.encode())
            h.update(init[k].numpy().tobytes())
        assert h.hexdigest() == want_init
        orders = workload.lane_orders(SEED, call, fold, trial.index,
                                      cfg["epochs"], T)
        assert sha(orders) == want_orders


@pytest.fixture(scope="module")
def tiny_pair():
    """(M, the tiny mean inputs, the tiny stacked inputs, the stacked
    configuration)."""
    mean, stacked = load(TINY, "tiny"), load(TINY, "tiny_stacked")
    assert stacked["data"]["predictor"] == "stacked"

    def rest(cfg):
        out = {k: v for k, v in cfg.items()
               if k not in ("name", "deployment")}
        out["data"] = {k: v for k, v in cfg["data"].items()
                       if k != "predictor"}
        return out

    assert rest(stacked) == rest(mean)
    return (mean["data"]["members"], workload.make_inputs(mean, SEED, "cpu"),
            workload.make_inputs(stacked, SEED, "cpu"), stacked)


def test_stacked_rows_are_the_members_in_member_major_order(tiny_pair):
    """Row m T + t is member m at time t: the rows averaged over m are the
    mean mode's x bit for bit, and the port's DataBundle.stacked() of the
    (T, M) members gives the same rows and the same tiled y."""
    from s2s_ismr_tpu_torch.data.bundle import DataBundle
    M, mean, st, cfg = tiny_pair
    assert st.predictor == "stacked"
    T, H, W, _ = mean.x.shape
    assert st.x.shape == (M * T, H, W, 1)
    members = st.x.reshape(M, T, H, W)
    assert torch.equal(members.mean(0)[..., None], mean.x)
    assert not torch.equal(st.x.reshape(T, M, H, W).mean(1)[..., None],
                           mean.x)
    x_st, y_st = workload.hindcast(cfg, SEED, "cpu")
    assert torch.equal(x_st, st.x)
    _, y = workload.hindcast(load(TINY, "tiny"), SEED, "cpu")
    b = DataBundle(x=members.permute(1, 0, 2, 3).numpy(), y=y.numpy(),
                   t=np.datetime64("2003-05-05") + 7 * np.arange(T),
                   lats=np.arange(H), lons=np.arange(W)).stacked()
    np.testing.assert_array_equal(b.x[:, 0], st.x[..., 0].numpy())
    np.testing.assert_array_equal(b.y, y_st.numpy())


def test_stacked_masks_are_the_mean_masks_tiled(tiny_pair):
    M, mean, st, _ = tiny_pair
    np.testing.assert_array_equal(st.train, np.tile(mean.train, (1, M)))
    np.testing.assert_array_equal(st.val, np.tile(mean.val, (1, M)))


def test_stacked_labels_are_a_linear_quantile_fit_over_the_tiled_pool(
        tiny_pair):
    """Per fold and ISO week w: the [1/3, 2/3] linear quantiles (numpy)
    over the tiled train rows whose week lies within one of w (wrapping at
    53); below the first class 0, above the second class 2, else 1; a week
    with no pooled row unlabelled. Every labelled pixel is one-hot, so the
    labels sum to M times the mean mode's."""
    M, mean, st, cfg = tiny_pair
    _, y = workload.hindcast(cfg, SEED, "cpu")
    y = y.numpy().reshape(y.shape[0], -1)
    d = cfg["data"]
    weeks = np.tile(workload.sample_dates(cfg["years"], d["season"],
                                          d["lead_days"])[1], M)
    for f in range(st.train.shape[0]):
        want = np.zeros(y.shape + (3,), np.float32)
        for w in np.unique(weeks):
            near = [((w + i - 1) % workload.N_ISO_WEEKS) + 1
                    for i in (-1, 0, 1)]
            rows = st.train[f] & np.isin(weeks, near)
            if not rows.any():
                continue
            q0, q1 = np.quantile(y[rows], [1 / 3, 2 / 3], axis=0,
                                 method="linear")
            v = y[weeks == w]
            cls = np.where(v < q0, 0, np.where(v > q1, 2, 1))
            want[weeks == w] = np.eye(3, dtype=np.float32)[cls]
        np.testing.assert_array_equal(
            st.y_onehot[f].reshape(want.shape).numpy(), want)
        assert float(st.y_onehot[f].sum()) == M * float(mean.y_onehot[f]
                                                        .sum())


def test_the_stacked_iitm_rows_take_22_eval_chunks():
    """tune_IITM_full stacked: 24 members x 437 dates = 10,488 rows; at
    64 x 64 a chunk holds 2,000,000 // 4,096 = 488 rows, so 21 of 488 and
    one of 10,488 - 21 x 488 = 240."""
    cfg = load(CONFIGS, "iitm_full_64")
    d = cfg["data"]
    T = len(workload.sample_dates(cfg["years"], d["season"],
                                  d["lead_days"])[0])
    assert d["members"] * T == 10_488
    assert counts.chunks(10_488, 64, 64) == [488] * 21 + [240]


def test_an_unknown_predictor_gives_no_result(tiny_root):
    cfg = load(TINY, "tiny")
    cfg["name"] = "tiny_multi"
    cfg["data"]["predictor"] = "multi_predictor"
    (tiny_root / "configs" / "tiny_multi.json").write_text(json.dumps(cfg))
    cell = load(os.path.join(HERE, "tiny", "cells"), "tiny_serial")
    (tiny_root / "cells" / "tiny_multi.json").write_text(json.dumps(
        dict(cell, config="tiny_multi")))
    rc, out, err = run_cell(tiny_args(tiny_root, "tiny_multi"))
    assert rc != 0 and out is None
    assert "'multi_predictor' is not one of mean, stacked" in \
        err.splitlines()[-1]
