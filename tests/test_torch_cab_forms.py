"""Kernel 7's one-launch tensor-core body (superresolution_tpu_torch/ops/
csrc/cab_kernels.cu) in its tile-by-tile form (utils/cab_forms.py), on
the CPU.

The CUDA body runs only on the card; cab_tile_form repeats one launch's
work tile by tile: the halo-2 staged tile, LN with zeros outside the
image, conv1 over the hidden halo as per-tap GEMMs on the packed weights
read back in the kernel's fragment order, GELU and zeros outside the
image, conv2 in passes of 8 fragments, the kernel's rounding points. It
is held against the reference's fused_cab_convs Pallas kernel in
interpret mode (pallas_hab.py:462) on ragged maps that are not multiples
of either tile height (8 or 16) or the tile width (16), at C 96 with
hidden 32, C 120 with hidden 40, and C 128 with c_real 96 (the lane pad).
The route rule (ops/hab.uses_tensor_cores) and kernel 7's launch
sequence and counts run on CPU tensors with each _build helper replaced
by an emulation, as tests/test_torch_dense_trunk_train.py runs B1's.

Tolerances, of max |ref|: 1e-4 in f32 against the Pallas kernel (the
reference's polynomial erf, test_torch_hab.py's bar); 0.02 in bf16
against the plain version in f32 on the same bf16 values (chip_smoke.py's
bar for kernel 7); each of the three faults chip_smoke.py plants in the
kernel must miss that bar by 3x."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_tpu.ops import pallas_hab as jhab
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import hab
from superresolution_tpu_torch.utils.cab_forms import cab_tile_form

TOL, F32_TOL, MARGIN = 0.02, 1e-4, 3
# (tag, B, H, W, C, hidden, c_real): ragged against 8 x 16 and 16 x 16
CASES = [("c96", 2, 13, 37, 96, 32, None),
         ("c120", 1, 18, 21, 120, 40, None),
         ("c128_creal96", 1, 10, 19, 128, 32, 96)]
FAULTS = {"ln_border": _build.PLANT_CAB_LN_BORDER,
          "hidden_border": _build.PLANT_CAB_HID_BORDER,
          "halo1": _build.PLANT_CAB_HALO1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = (t.float() if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.array(t, np.float32))
                for t in (got, ref))
    assert got.shape == ref.shape
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max())


def _case(seed, b, h, w, c, mid, c_real):
    """Numpy inputs at C (lanes past c_real zero): x, and the six weights
    with a large LN bias and nonzero conv biases, so a conv that saw LN(0)
    or GELU(b1) outside the image would differ."""
    rng = np.random.default_rng(seed)
    cr = c_real or c

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = r(b, h, w, c)
    ln_s, ln_b = 1 + r(c, s=0.1), r(c, s=0.5)
    k1, b1 = r(3, 3, c, mid, s=(2 / (9 * cr)) ** 0.5), r(mid, s=0.5)
    k2, b2 = r(3, 3, mid, c, s=(2 / (9 * mid)) ** 0.5), r(c, s=0.5)
    for a in (x, ln_s, ln_b, b2):
        a[..., cr:] = 0
    k1[:, :, cr:], k2[..., cr:] = 0, 0
    return x, [ln_s, ln_b, k1, b1, k2, b2]


def _jax_ref(x, ws, c_real):
    ln_s, ln_b, k1, b1, k2, b2 = ws
    hp = {"LayerNorm_0": {"scale": ln_s, "bias": ln_b},
          "ChannelAttentionBlock_0": {
              "Conv_0": {"Conv_0": {"kernel": k1, "bias": b1}},
              "Conv_1": {"Conv_0": {"kernel": k2, "bias": b2}}}}
    return jhab.fused_cab_convs(jnp.asarray(x),
                                jhab.cab_weights(hp, jnp.float32),
                                interpret=True, c_real=c_real)


def _torch(ws, dtype=torch.float32):
    """The six weights as torch tensors (kernels in `dtype`) and packed."""
    t = [torch.from_numpy(a) for a in ws]
    t[2], t[4] = t[2].to(dtype), t[4].to(dtype)
    return hab.cab_mma_weights(t)


@pytest.mark.parametrize("th", [8, 16])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tile_form_matches_jax_kernel(case, th):
    """The form in f32 against the Pallas kernel, and its hidden map
    against the plain version's."""
    tag, b, h, w, c, mid, cr = case
    x, ws = _case(len(tag) + th, b, h, w, c, mid, cr)
    tw = _torch(ws)
    hid = torch.full((b, h, w, mid), float("nan"))
    got = cab_tile_form(torch.from_numpy(x), tw, th=th, c_real=cr,
                        hidden=hid)
    assert _rel(got, _jax_ref(x, ws, cr)) < F32_TOL
    hid_ref = torch.empty(hid.shape)
    hab.fused_cab_convs_reference(torch.from_numpy(x), tw, hid_ref, cr)
    assert _rel(hid, hid_ref) < F32_TOL
    if cr:
        assert not got[..., cr:].any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tile_form_bf16_within_the_bar(case):
    """In bf16 (the kernel's rounding points) against the plain version in
    f32 on the same bf16 values, within chip_smoke.py's bar."""
    tag, b, h, w, c, mid, cr = case
    x, ws = _case(len(tag), b, h, w, c, mid, cr)
    tw = _torch(ws, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    ref = hab.fused_cab_convs_reference(xb.float(), tw, c_real=cr)
    got = cab_tile_form(xb, tw, c_real=cr)
    assert got.dtype == torch.bfloat16
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_planted_faults_miss_by_3x(case, fault):
    """Each fault chip_smoke.py plants in the kernel, planted in the form:
    the bf16 output misses the plain version by 3x the bar."""
    tag, b, h, w, c, mid, cr = case
    x, ws = _case(len(tag), b, h, w, c, mid, cr)
    tw = _torch(ws, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    ref = hab.fused_cab_convs_reference(xb.float(), tw, c_real=cr)
    got = cab_tile_form(xb, tw, c_real=cr, plant=FAULTS[fault])
    assert _rel(got, ref) > MARGIN * TOL


def test_tap_block_inverts_the_packing():
    """pack_conv_mma then the kernel's fragment reads give back each
    tap's block, K zero-padded to 16, in conv2's column passes too."""
    k = torch.randn(3, 3, 40, 120)
    packed = hab.pack_conv_mma(k)
    assert tuple(packed.shape) == (27, 15, 32, 4)
    from superresolution_tpu_torch.utils.cab_forms import tap_block
    for tap in range(9):
        want = F.pad(k[tap // 3, tap % 3], (0, 0, 0, 8))
        assert torch.equal(tap_block(packed, tap), want)
        assert torch.equal(tap_block(packed, tap, 8, 7), want[:, 64:])


@pytest.mark.parametrize("c,mid,dtype,tc", [
    (96, 32, torch.bfloat16, True), (120, 40, torch.bfloat16, True),
    (128, 32, torch.bfloat16, True), (96, 32, torch.float32, False),
    (36, 12, torch.bfloat16, False), (100, 32, torch.bfloat16, False),
    (136, 40, torch.bfloat16, False), (96, 72, torch.bfloat16, False)])
def test_route_rule(c, mid, dtype, tc):
    assert hab.uses_tensor_cores(torch.zeros(1, 2, 2, c, dtype=dtype),
                                 mid) is tc


def _emu_layernorm(x, s, b, out, c_real=None):
    out.copy_(hab.layer_norm(x, s, b, c_real))


def _emu_conv3x3(in0, cin0, w, bias, out, out_off, cout, *, geom,
                 gelu=False):
    v = F.conv2d(in0[..., :cin0].float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), bias, padding=1)
    v = v.permute(0, 2, 3, 1)
    out[..., out_off:out_off + cout] = F.gelu(v) if gelu else v


def _emu_cab_tc(x, weights, out, hidden=None, c_real=None, plant=0):
    out.copy_(cab_tile_form(x, weights, c_real=c_real, hidden=hidden,
                            plant=plant))


@pytest.mark.parametrize("c,mid,tc", [(96, 32, True), (120, 40, True),
                                      (36, 12, False)])
def test_launch_sequence_follows_the_route(monkeypatch, c, mid, tc):
    """cab_launches on CPU tensors with require_cuda's device rule off and
    each launch helper an emulation: the tensor-core body is one counted
    launch, the other body three; launches counts the call either way;
    the result is within the bar of the plain version."""
    calls = []

    def spy(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    for name, fn in (("cab_tc", _emu_cab_tc), ("layernorm", _emu_layernorm),
                     ("conv3x3", _emu_conv3x3)):
        monkeypatch.setattr(_build, name, spy(name, fn))
    x, ws = _case(c, 1, 11, 23, c, mid, None)
    tw = _torch(ws, torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    op = hab.fused_cab_convs
    before = (op.launches, op.tc_launches, op.direct_launches)
    out = torch.empty_like(xb)
    hid = torch.empty((1, 11, 23, mid), dtype=torch.bfloat16)
    hab.cab_launches(xb, tw, out, hid)
    assert calls == (["cab_tc"] if tc else
                     ["layernorm", "conv3x3", "conv3x3"])
    assert (op.launches, op.tc_launches, op.direct_launches) == (
        before[0] + 1, before[1] + tc, before[2] + 3 * (not tc))
    hid_ref = torch.empty(hid.shape)
    ref = hab.fused_cab_convs_reference(xb.float(), tw, hid_ref)
    assert _rel(out, ref) < TOL
    assert _rel(hid, hid_ref) < TOL
    if tc:  # the tensor-core body reads the packing; it is not made here
        with pytest.raises(ValueError, match="packed"):
            hab.cab_launches(xb, tw[:6], out)


def test_cpu_call_counts_nothing():
    op = hab.fused_cab_convs
    before = (op.launches, op.tc_launches, op.direct_launches)
    x, ws = _case(3, 1, 5, 6, 96, 32, None)
    hab.fused_cab_convs(torch.from_numpy(x), _torch(ws))
    assert (op.launches, op.tc_launches, op.direct_launches) == before
