"""The port's Loader (superresolution_tpu_torch/data/loader.py) yields
the JAX package's batches (same order from the same seed, drop_last,
pad_to_batch with `_valid`), and prefetch_to_device hands them out as
tensors on the CPU when asked for it."""

import numpy as np
import pytest
import torch

from superresolution_tpu.data.loader import Loader as JaxLoader
from superresolution_tpu_torch.data.dataset import SyntheticHRDataset
from superresolution_tpu_torch.data.loader import Loader, prefetch_to_device


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3, num_workers=2),
    dict(shuffle=False, num_workers=3, drop_last=False, pad_to_batch=True)])
def test_loader_matches_jax(kw):
    ds = SyntheticHRDataset(7, 16, 1, seed=1, lr_scale=2)
    a, b = Loader(ds, 3, **kw), JaxLoader(ds, 3, **kw)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, ref = list(a), list(b)
        assert len(a) == len(b) == len(got) == len(ref)
        for x, y in zip(got, ref):
            assert set(x) == set(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    if kw.get("pad_to_batch"):
        assert got[-1]["_valid"].tolist() == [True, False, False]


def test_prefetch_to_device_on_cpu():
    ds = SyntheticHRDataset(5, 16, 1, seed=1, lr_scale=2)
    batches = list(prefetch_to_device(Loader(ds, 2, shuffle=False,
                                             num_workers=1), size=2,
                                      device="cpu"))
    assert len(batches) == 2
    for i, b in enumerate(batches):
        assert isinstance(b["hr"], torch.Tensor)
        assert b["hr"].shape == (2, 16, 16, 1) and b["lr"].shape[1] == 8
        np.testing.assert_array_equal(b["hr"][0].numpy(), ds[2 * i]["hr"])
