"""Kernel 12 (superresolution_tpu_torch/ops/hab.py: fused_cab_convs_pair)
on kernel 7's one-launch tensor-core body, on the CPU.

On the card kernel 12 is one launch of cab_kernels.cu's cab_tc_kernel
with the LN divided by C, counted on its own `launches`. Here that launch
(_build.cab_tc) is emulated by kernel 7's tile form (utils/cab_forms.py,
16-row tiles as the kernel's), so hab.cab_pair_launch runs on CPU
tensors and is held against the reference's pair-packed Pallas kernel in
interpret mode (superresolution_tpu/ops/pallas_hab.py:613) on an
even-width map ragged against the 16 x 16 tiles, C 24 with hidden 8 (the
route rule forced for f32), within 1e-4 of max |ref|. Also: kernel 7's
counters do not move; an odd width, and shapes off kernel 7's route rule,
raise; the swap-pair fault chip_smoke.py plants (each stored column's x
XOR 1) misses kernel 7's bf16 bar of 0.02 by 3x, as does the unzeroed
hidden map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_hab as jhab
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import hab
from superresolution_tpu_torch.utils.cab_forms import cab_tile_form

TOL, F32_TOL, MARGIN = 0.02, 1e-4, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(b, h, w, c, mid, seed):
    """x N(0, 1) and CAB weights with a large LN bias and N(0, 0.3^2)
    conv biases (outside the image each conv must see zeros, not LN(0)
    or GELU(b1)), as numpy, and the reference's param subtree."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    ln_b = (0.5 * rng.standard_normal(c) + 1.0).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, c, mid)) * np.sqrt(2 / (9 * c))).astype(
        np.float32)
    b1 = (0.3 * rng.standard_normal(mid)).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, mid, c))
          * np.sqrt(2 / (9 * mid))).astype(np.float32)
    b2 = (0.3 * rng.standard_normal(c)).astype(np.float32)
    hp = {"LayerNorm_0": {"scale": ln_s, "bias": ln_b},
          "ChannelAttentionBlock_0": {
              "Conv_0": {"Conv_0": {"kernel": k1, "bias": b1}},
              "Conv_1": {"Conv_0": {"kernel": k2, "bias": b2}}}}
    return x, hp, [ln_s, ln_b, k1, b1, k2, b2]


def _weights(ws, dtype):
    t = [torch.from_numpy(a) for a in ws]
    t[2], t[4] = t[2].to(dtype), t[4].to(dtype)
    return hab.cab_mma_weights(t)


def _rel(got, ref) -> float:
    got = got.float()
    ref = (ref.float() if isinstance(ref, torch.Tensor)
           else torch.from_numpy(np.array(ref, np.float32)))
    assert got.shape == ref.shape
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max())


class _Launch:
    """_build.cab_tc as kernel 7's tile form (16-row tiles), logged;
    require_cuda's device rule off."""

    def __init__(self, monkeypatch, plant=0):
        self.calls = []
        self.plant = plant
        monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
        monkeypatch.setattr(_build, "cab_tc", self._cab_tc)

    def _cab_tc(self, x, weights, out, hidden=None, c_real=None, plant=0):
        self.calls.append(c_real)
        out.copy_(cab_tile_form(x, weights, th=16, c_real=c_real,
                                hidden=hidden, plant=plant | self.plant))


def _counts():
    k7 = hab.fused_cab_convs
    return ((k7.launches, k7.tc_launches, k7.direct_launches),
            hab.fused_cab_convs_pair.launches)


@pytest.mark.parametrize("b,h,w", [(2, 13, 34), (1, 18, 20)])
def test_one_launch_matches_jax_pair_kernel_f32(monkeypatch, b, h, w):
    x, hp, ws = _case(b, h, w, 24, 8, seed=h * w)
    ref = jhab.fused_cab_convs_pair(jnp.asarray(x),
                                    jhab.cab_pair_weights(hp, jnp.float32),
                                    interpret=True)
    launch = _Launch(monkeypatch)
    monkeypatch.setattr(hab, "uses_tensor_cores", lambda *a: True)
    k7, k12 = _counts()
    got = hab.cab_pair_launch(torch.from_numpy(x),
                              _weights(ws, torch.float32))
    assert launch.calls == [None]  # one launch, the LN divided by C
    assert _counts() == (k7, k12 + 1)
    assert _rel(got, ref) < F32_TOL


def test_bf16_on_the_rule_within_the_bar(monkeypatch):
    launch = _Launch(monkeypatch)
    x, _, ws = _case(1, 21, 38, 24, 8, seed=3)
    tw = _weights(ws, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    k7, k12 = _counts()
    got = hab.cab_pair_launch(xb, tw)
    assert launch.calls == [None] and got.dtype == torch.bfloat16
    assert _counts() == (k7, k12 + 1)
    assert _rel(got, hab.fused_cab_convs_pair_reference(xb.float(), tw)) < TOL


@pytest.mark.parametrize("bit", [_build.PLANT_CAB_SWAP_PAIR,
                                 _build.PLANT_CAB_HID_BORDER])
def test_planted_faults_miss_by_three_bars(monkeypatch, bit):
    _Launch(monkeypatch, plant=bit)
    x, _, ws = _case(1, 21, 38, 24, 8, seed=4)
    tw = _weights(ws, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    bad = hab.cab_pair_launch(xb, tw)
    ref = hab.fused_cab_convs_pair_reference(xb.float(), tw)
    assert _rel(bad, ref) > MARGIN * TOL


@pytest.mark.parametrize("c,mid,dtype", [
    (12, 4, torch.bfloat16), (24, 8, torch.float32),
    (136, 40, torch.bfloat16), (96, 72, torch.bfloat16)])
def test_off_the_route_rule_raises(monkeypatch, c, mid, dtype):
    launch = _Launch(monkeypatch)
    x, _, ws = _case(1, 4, 6, c, mid, seed=c)
    before = _counts()
    with pytest.raises(ValueError, match="route rule"):
        hab.cab_pair_launch(torch.from_numpy(x).to(dtype),
                            _weights(ws, dtype))
    assert launch.calls == [] and _counts() == before


def test_odd_width_raises_and_packing_is_needed(monkeypatch):
    _Launch(monkeypatch)
    x, _, ws = _case(1, 4, 7, 24, 8, seed=1)
    with pytest.raises(ValueError, match="even width"):
        hab.fused_cab_convs_pair(torch.from_numpy(x).bfloat16(),
                                 _weights(ws, torch.bfloat16))
    x, _, ws = _case(1, 4, 8, 24, 8, seed=1)
    with pytest.raises(ValueError, match="packed"):
        hab.cab_pair_launch(torch.from_numpy(x).bfloat16(),
                            _weights(ws, torch.bfloat16)[:6])


def test_swap_pair_bit_swaps_each_pair_of_columns():
    """The tile form's fault stores column x at x XOR 1: at an even width
    the output is the clean one with each pair of columns swapped."""
    x, _, ws = _case(1, 5, 34, 24, 8, seed=2)
    tw = _weights(ws, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    clean = cab_tile_form(xb, tw, th=16)
    bad = cab_tile_form(xb, tw, th=16, plant=_build.PLANT_CAB_SWAP_PAIR)
    assert torch.equal(bad, clean[:, :, torch.arange(34) ^ 1])
