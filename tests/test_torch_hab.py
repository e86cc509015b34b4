"""Kernels 7 and 8 (superresolution_tpu_torch/ops/hab.py): the port's
plain versions against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs, in f32 to 1e-4 of max |ref| (the one
modelled difference is the reference's polynomial erf, 1.5e-7). On the
CPU the wrappers run the plain versions, so each case goes through the
wrapper too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_tpu.ops import pallas_hab as jhab
from superresolution_tpu_torch.ops import hab

TOL = 1e-4


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < tol, err


@pytest.mark.parametrize("h,w,c", [(8, 10, 12), (12, 7, 12), (6, 16, 6)])
def test_fused_cab_convs_matches_jax_kernel(h, w, c):
    """Ragged sides and nonzero LN and conv biases: outside the image
    the convs must see zeros, not LN(0) = ln bias or GELU(bias)."""
    rng = np.random.default_rng(h * w)
    mid = c // 3
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    ln_b = (0.5 * rng.standard_normal(c)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, c, mid)) / np.sqrt(9 * c)).astype(
        np.float32)
    b1 = (0.3 * rng.standard_normal(mid)).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, mid, c)) / np.sqrt(9 * mid)).astype(
        np.float32)
    b2 = (0.3 * rng.standard_normal(c)).astype(np.float32)
    hp = {"LayerNorm_0": {"scale": ln_s, "bias": ln_b},
          "ChannelAttentionBlock_0": {
              "Conv_0": {"Conv_0": {"kernel": k1, "bias": b1}},
              "Conv_1": {"Conv_0": {"kernel": k2, "bias": b2}}}}
    ref = jhab.fused_cab_convs(jnp.asarray(x),
                               jhab.cab_weights(hp, jnp.float32),
                               interpret=True)
    weights = [torch.from_numpy(a) for a in (ln_s, ln_b, k1, b1, k2, b2)]
    got = hab.fused_cab_convs(torch.from_numpy(x), weights)
    _close(got.numpy(), ref)


def _hab_case(seed, nb=8, n=16, c=12, nh=3, mlp=24):
    """Inputs and both weight layouts. rpb and the q/k weights are large
    enough that the softmax is far from uniform."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x, cab = r(nb, n, c, s=1.0), r(nb, n, c, s=0.3)
    jw = {"ln1_s": 1 + r(1, c), "ln1_b": r(1, c), "wq": r(c, c, s=0.6),
          "wk": r(c, c, s=0.6), "wv": r(c, c, s=0.3), "bq": r(1, c),
          "bk": r(1, c), "bv": r(1, c), "rpb": r(nh, n, n, s=1.0),
          "wp": r(c, c, s=0.3), "bp": r(1, c), "ln2_s": 1 + r(1, c),
          "ln2_b": r(1, c), "w1": r(c, mlp, s=0.3), "b1": r(1, mlp),
          "w2": r(mlp, c, s=0.3), "b2": r(1, c)}
    tw = {k: torch.from_numpy(v.reshape(-1) if v.shape[0] == 1 else v)
          for k, v in jw.items() if k[:2] not in ("wq", "wk", "wv", "bq",
                                                  "bk", "bv")}
    tw["wqkv"] = torch.from_numpy(np.concatenate(
        [jw["wq"], jw["wk"], jw["wv"]], axis=1))
    tw["bqkv"] = torch.from_numpy(np.concatenate(
        [jw["bq"], jw["bk"], jw["bv"]], axis=1).reshape(-1))
    assert set(tw) == set(hab.HAB_WEIGHTS)
    ids = rng.integers(0, 3, (4, n)).astype(np.int32)
    return x, cab, jw, tw, ids


@pytest.mark.parametrize("stacked", ["1", "0"])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_hab_block_matches_jax_kernel(masked, stacked, monkeypatch):
    """Both of the reference kernel's attention layouts; masked windows
    take region_ids[b % nW_img]."""
    monkeypatch.setenv("SRTPU_STACKED_ATTN", stacked)
    x, cab, jw, tw, ids = _hab_case(3 + masked)
    jids = jnp.asarray(ids) if masked else None
    ref = jhab.fused_hab_block(jnp.asarray(x), jnp.asarray(cab), 3, True,
                               {k: jnp.asarray(v) for k, v in jw.items()},
                               jids)
    tids = torch.from_numpy(ids) if masked else None
    got = hab.fused_hab_block(torch.from_numpy(x), torch.from_numpy(cab), 3,
                              tw, tids)
    _close(got.numpy(), ref)
    # the attention + MLP part alone, which the identity x + cab hides
    part = got.numpy() - x - cab
    _close(part, np.asarray(ref) - x - cab, 3 * TOL)


def test_fused_hab_block_mask_changes_the_result():
    """The region mask is not a no-op at this geometry (else the masked
    case above would not test it)."""
    x, cab, _, tw, ids = _hab_case(5)
    args = (torch.from_numpy(x), torch.from_numpy(cab), 3, tw)
    a = hab.fused_hab_block(*args, torch.from_numpy(ids))
    b = hab.fused_hab_block(*args, None)
    assert float((a - b).abs().max()) > 1e-2


def test_fused_hab_block_checks_shapes():
    x, cab, _, tw, ids = _hab_case(6)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="cab"):
        hab.fused_hab_block(xt, xt[:4], 3, tw)
    with pytest.raises(ValueError, match="region ids"):
        hab.fused_hab_block(xt, torch.from_numpy(cab), 3, tw,
                            torch.from_numpy(ids[:3]))


@pytest.mark.parametrize("k,n", [(96, 288), (120, 360), (128, 384),
                                 (192, 96), (240, 120)])
def test_mma_packing_holds_the_unpacked_weights(k, n):
    """Kernel 8's tensor-core packing (hab.pack_mma) against the unpacked
    [K, N] kernel: entry [ks, j, 4 g + t, e] is w[16 ks + 8 (e // 2) + 2 t
    + e % 2, 8 j + g], the rows past K zero (K 120 pads to 128)."""
    w = torch.from_numpy(np.random.default_rng(k + n).standard_normal(
        (k, n)).astype(np.float32))
    p = hab.pack_mma(w)
    kp = -(-k // 16) * 16
    assert p.shape == (kp // 16, n // 8, 32, 4) and p.is_contiguous()
    ks, j, lane, e = np.meshgrid(np.arange(kp // 16), np.arange(n // 8),
                                 np.arange(32), np.arange(4), indexing="ij")
    rows = 16 * ks + 8 * (e // 2) + 2 * (lane % 4) + e % 2
    cols = 8 * j + lane // 4
    want = np.where(rows < k, F.pad(w, (0, 0, 0, kp - k)).numpy()[
        np.minimum(rows, kp - 1), cols], 0.0)
    np.testing.assert_array_equal(p.numpy(), want)


def test_hab_weights_carry_their_packing(monkeypatch):
    """hab_weights packs each dense kernel once (mma_weights); mma_weights
    replaces a packing it finds; the kernels' weight check wants every
    packing."""
    rng = np.random.default_rng(0)
    c, nh, ws = 16, 2, 4
    pre = "b"
    sd = {f"{pre}.norm1.weight": rng.standard_normal(c),
          f"{pre}.norm1.bias": rng.standard_normal(c),
          f"{pre}.attn.qkv.weight": rng.standard_normal((3 * c, c)),
          f"{pre}.attn.qkv.bias": rng.standard_normal(3 * c),
          f"{pre}.attn.relative_position_bias_table":
              rng.standard_normal(((2 * ws - 1) ** 2, nh)),
          f"{pre}.attn.proj.weight": rng.standard_normal((c, c)),
          f"{pre}.attn.proj.bias": rng.standard_normal(c),
          f"{pre}.norm2.weight": rng.standard_normal(c),
          f"{pre}.norm2.bias": rng.standard_normal(c),
          f"{pre}.mlp.fc1.weight": rng.standard_normal((2 * c, c)),
          f"{pre}.mlp.fc1.bias": rng.standard_normal(2 * c),
          f"{pre}.mlp.fc2.weight": rng.standard_normal((c, 2 * c)),
          f"{pre}.mlp.fc2.bias": rng.standard_normal(c)}
    w = hab.hab_weights({k: torch.tensor(v, dtype=torch.float32)
                         for k, v in sd.items()}, pre, nh, ws,
                        torch.float32)
    for name in ("wqkv", "wp", "w1", "w2"):
        torch.testing.assert_close(w[name + "_mma"], hab.pack_mma(w[name]),
                                   rtol=0, atol=0)
    stale = dict(w, wp_mma=torch.zeros(1))
    torch.testing.assert_close(hab.mma_weights(stale)["wp_mma"],
                               hab.pack_mma(w["wp"]), rtol=0, atol=0)
    unpacked = {k: v for k, v in w.items() if k != "w1_mma"}
    # past the device checks (no card here) to the packing's
    monkeypatch.setattr(hab._build, "require_cuda", lambda *a, **k: None)
    with pytest.raises(ValueError, match="no w1_mma"):
        hab.check_hab_weights("fused_hab_block", unpacked, c, nh, ws * ws,
                              ((c, nh, ws * ws, 2 * c),))
