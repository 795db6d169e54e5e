"""The port's synthetic Criteo stream against the contract of the
reference's ``batch_at`` (``src/repro/data/criteo.py:47-65,144-151``):
shapes, dtypes and ranges; stateless per ``(seed, step)``; Zipf ids whose
head mass per feature follows its closed form; labels from the planted
logistic model.  ``jax.random`` bits cannot be reproduced in torch, so
the port's batches never equal the reference's: the contract is
statistical, and cross-framework comparisons carry the reference's
batches across (``test_torch_predict.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data.criteo import CriteoSpec as JaxSpec
from repro.data.criteo import batch_at as jax_batch_at
from repro_torch.configs import dlrm_criteo
from repro_torch.configs.common import Shape
from repro_torch.data import criteo
from repro_torch.data.criteo import CriteoSpec, batch_at

SIZES = (1460, 583, 10131227, 3, 24, 2202608, 4)


def test_batch_shapes_dtypes_and_ranges():
    spec = CriteoSpec(table_sizes=SIZES, zipf=1.5, noise=0.5)
    b = batch_at(0, 7, 64, spec, device="cpu")
    assert b["dense"].shape == (64, 13) and b["dense"].dtype == torch.float32
    assert b["sparse"].shape == (64, len(SIZES)) and b["sparse"].dtype == torch.int32
    assert b["label"].shape == (64,) and b["label"].dtype == torch.float32
    assert set(b["label"].tolist()) <= {0.0, 1.0}
    sizes = torch.tensor(SIZES)
    assert (b["sparse"] >= 0).all() and (b["sparse"] < sizes).all()
    assert all(t.device.type == "cpu" for t in b.values())


def test_stateless_per_seed_and_step():
    spec = CriteoSpec(table_sizes=SIZES)
    first = batch_at(3, 11, 32, spec, device="cpu")
    again = batch_at(3, 11, 32, spec, device="cpu")
    for k in first:
        torch.testing.assert_close(first[k], again[k], rtol=0, atol=0)
    for other in (batch_at(3, 12, 32, spec, device="cpu"), batch_at(4, 11, 32, spec, device="cpu")):
        assert not torch.equal(first["dense"], other["dense"])
        assert not torch.equal(first["sparse"], other["sparse"])


@pytest.mark.parametrize("zipf", [1.5, 3.0])
def test_head_mass_per_feature_follows_closed_form(zipf):
    """P(id < k) = P(u^zipf < k/S) = (k/S)^(1/zipf) for an integer k: the
    share of each feature's draws below k is within 5 sigma of it."""
    spec = CriteoSpec(table_sizes=SIZES, zipf=zipf)
    n = 40_000
    sparse = batch_at(0, 0, n, spec, device="cpu")["sparse"].numpy()
    for j, size in enumerate(SIZES):
        for t in (0.001, 0.05, 0.5):
            k = max(1, int(np.ceil(t * size)))
            p = min(1.0, (k / size) ** (1.0 / zipf))
            share = float(np.mean(sparse[:, j] < k))
            sigma = np.sqrt(max(p * (1 - p), 1e-12) / n)
            assert abs(share - p) <= 5 * sigma + 1e-9, (size, k, share, p)


def test_labels_follow_the_planted_model():
    """With no noise the label is exactly ``dense·w_d + Σ sin(sparse·c)·a > 0``
    over the planted weights, which do not depend on the step."""
    spec = CriteoSpec(table_sizes=SIZES, noise=0.0)
    for step in (0, 5):
        b = batch_at(2, step, 256, spec, device="cpu")
        w_d = criteo._planted(2, "wd", (13,))
        a = criteo._planted(2, "a", (len(SIZES),))
        c = criteo._planted(2, "c", (len(SIZES),)) * 5.0
        score = b["dense"] @ w_d + torch.sum(torch.sin(b["sparse"] * c) * a, dim=-1)
        torch.testing.assert_close(b["label"], (score > 0).float(), rtol=0, atol=0)
        assert 0.1 < float(b["label"].mean()) < 0.9
    torch.testing.assert_close(criteo._planted(2, "a", (4,)), criteo._planted(2, "a", (4,)))
    assert not torch.equal(criteo._planted(2, "a", (4,)), criteo._planted(3, "a", (4,)))


def test_never_equal_bits_with_the_reference():
    """Same contract, other bits: the batches differ from the reference's
    draws for the same (seed, step), with the same shapes and dtypes."""
    spec = CriteoSpec(table_sizes=SIZES, zipf=1.5, noise=0.5)
    jspec = JaxSpec(table_sizes=SIZES, zipf=1.5, noise=0.5)
    ours = batch_at(0, 10_000, 128, spec, device="cpu")
    theirs = {k: np.asarray(v) for k, v in jax_batch_at(0, 10_000, 128, jspec).items()}
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape
        assert str(ours[k].dtype).split(".")[-1] == str(theirs[k].dtype)
    assert not np.array_equal(ours["dense"].numpy(), theirs["dense"])
    assert not np.array_equal(ours["sparse"].numpy(), theirs["sparse"])


def test_api_batch_fn_is_batch_at_seed_0():
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True), table_sizes=SIZES)
    api = dlrm_criteo.api(cfg, device="cpu")
    got = api.batch_fn(10_003, Shape("bench", 1, 16, "train"))
    want = batch_at(0, 10_003, 16, CriteoSpec(table_sizes=SIZES, zipf=1.5, noise=0.5),
                    device="cpu")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
