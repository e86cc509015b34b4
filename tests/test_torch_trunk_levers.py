"""Kernels 4-6 (superresolution_tpu_torch/ops/dense_trunk.py:
fused_dense_block_prologue, fused_dense_block_epilogue, fused_rrdb) and
the trunk levers that run them (infer/fused_trunk.make_fused_trunk
fold_ends / chain_rrdb) against the JAX package on the CPU, where the
port's ops run their plain versions and the JAX Pallas kernels run in
interpret mode, in f32 on the same numpy-seeded inputs and weights.

Tolerances, of max |ref|:
  * 1e-5 for the ops and 1e-4 for a whole trunk against the JAX kernels
    and make_fused_trunk: the same f32 arithmetic in another order (the
    roll-conv's three partial products, one conv per F.conv2d);
  * 2e-2 for a trunk against model.apply(method="trunk"): both fused
    trunks keep the dense-block kernels in bf16, as the reference's
    proj_weights does, and the plain model computes in f32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer.fused_trunk import (
    make_fused_trunk as jax_make_fused_trunk,
)
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu.models.rrdbnet import FusedDenseBlock as JaxFDB
from superresolution_tpu.ops import pallas_dense_trunk as jpd
from superresolution_tpu_torch.infer.common import hwio
from superresolution_tpu_torch.infer.fused_trunk import make_fused_trunk
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops import dense_trunk as dt
from test_torch_hat_lite import jax_variables

C, G, H, W = 16, 8, 16, 20
OP_TOL, TRUNK_TOL, APPLY_TOL = 1e-5, 1e-4, 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _block(seed):
    """One dense block's params (biases N(0, 0.1)) as the JAX kernels'
    f32 proj weights and the port's f32 weight list."""
    dp = jax_variables(JaxFDB(features=C, growth=G), (1, 8, 8, C),
                       seed=seed)["params"]
    return (jpd.proj_weights(dp, dtype=jnp.float32),
            dt.dense_weights(*convert._unfuse_dense(dp, C, G),
                             dtype=torch.float32))


def _conv(seed, cin, cout):
    """A 3x3 conv's params as the JAX end-fold weights and the port's
    (HWIO kernel, bias) pair."""
    k = _randn(seed, 3, 3, cin, cout, scale=(2 / (9 * cin)) ** 0.5)
    b = _randn(seed + 1, cout, scale=0.1)
    cin_pad = -(-cin // 8) * 8
    jw = jpd.conv3_rollconv_weights({"kernel": k, "bias": b},
                                    cin_pad=cin_pad, dtype=jnp.float32)
    return jw, (torch.from_numpy(k), torch.from_numpy(b))


def _pad_channels(x, to):
    return np.pad(x, ((0, 0), (0, 0), (0, 0), (0, to - x.shape[-1])))


@pytest.mark.parametrize("cin", [3, 4])
def test_prologue_matches_jax(cin):
    """conv_first at Cin 3 (RGB) and 4 (1 channel after unshuffle x2),
    then dense block 0: both outputs."""
    x = _randn(cin, 2, H, W, cin)
    jw, tw = _block(1)
    jhead, thead = _conv(30 + cin, cin, C)
    jout, jh = jpd.fused_dense_block_prologue(
        jpd.pack(_pad_channels(x, 8)), jhead, jw, width=W, rb=8,
        interpret=True)
    before = dt.fused_dense_block_prologue.launches
    out, head = dt.fused_dense_block_prologue(torch.from_numpy(x), thead, tw)
    assert _rel(head, jpd.unpack(jh, W)) < OP_TOL
    assert _rel(out, jpd.unpack(jout, W)) < OP_TOL
    # the CPU launches none; other tests in this process may have counted
    assert dt.fused_dense_block_prologue.launches == before


def test_epilogue_matches_jax():
    x, res, head = (_randn(s, 2, H, W, C, scale=0.5) for s in (5, 6, 7))
    jw, tw = _block(2)
    jtrunk, ttrunk = _conv(40, C, C)
    ref = jpd.fused_dense_block_epilogue(
        jpd.pack(x), jw, jpd.pack(res), jtrunk, jpd.pack(head), width=W,
        rb=8, interpret=True)
    got = dt.fused_dense_block_epilogue(
        torch.from_numpy(x), tw, torch.from_numpy(res), ttrunk,
        torch.from_numpy(head))
    assert _rel(got, jpd.unpack(ref, W)) < OP_TOL


def test_fused_rrdb_matches_jax():
    x = _randn(8, 2, H, W, C, scale=0.5)
    blocks = [_block(10 + i) for i in range(3)]
    ref = jpd.fused_rrdb(jpd.pack(x), *(jw for jw, _ in blocks), width=W,
                         rb=8, interpret=True)
    got = dt.fused_rrdb(torch.from_numpy(x), *(tw for _, tw in blocks))
    assert _rel(got, jpd.unpack(ref, W)) < OP_TOL
    # and it is three B1 calls, the RRDB residual in the third
    y = dt.fused_dense_block(torch.from_numpy(x), blocks[0][1])
    y = dt.fused_dense_block(y, blocks[1][1])
    y = dt.fused_dense_block(y, blocks[2][1], residual=torch.from_numpy(x))
    torch.testing.assert_close(got, y, rtol=0, atol=0)


TRUNKS = {
    "3_blocks": dict(scale=4, in_channels=3, out_channels=3, num_blocks=3),
    "2_blocks": dict(scale=4, in_channels=3, out_channels=3, num_blocks=2),
    "unshuffle_x2": dict(scale=2, in_channels=1, out_channels=1,
                         num_blocks=2, pixel_unshuffle_input=2),
}


@functools.lru_cache(maxsize=None)
def _trunk(name):
    args = dict(TRUNKS[name], features=C, growth=G, upsampler="pixelshuffle")
    jm = JaxRRDBNet(**args)
    variables = jax_variables(jm, (1, 8, 8, args["in_channels"]),
                              seed=len(name))
    sd = convert.rrdbnet_state_dict_from_jax(
        variables, num_blocks=args["num_blocks"], features=C, growth=G)
    x = _randn(len(name), 2, H, W, args["in_channels"])
    ref = np.asarray(jax.jit(functools.partial(jm.apply, method="trunk"))(
        variables, jnp.asarray(x)))
    return jm, variables, sd, RRDBNet(**args, device="cpu"), x, ref


@pytest.mark.parametrize("name", sorted(TRUNKS))
@pytest.mark.parametrize("lever", ["fold_ends", "chain_rrdb"])
def test_trunk_levers_match_jax_and_apply(name, lever):
    jm, variables, sd, tm, x, ref = _trunk(name)
    kw = {lever: True}
    jref = jax_make_fused_trunk(variables, jm, interpret=True, **kw)(x)
    got = make_fused_trunk(sd, tm, device="cpu", **kw)(torch.from_numpy(x))
    assert _rel(got, jref) < TRUNK_TOL
    assert _rel(got, ref) < APPLY_TOL


def test_levers_run_their_kernels_and_fold_ends_gives_way():
    """Which ops each lever calls, counted through the wrappers the CPU
    path runs: fold_ends at 3 RRDBs runs kernel 4 once, 7 B1 calls and
    kernel 5 once; chain_rrdb runs kernel 6 per RRDB and no B1; under
    chain_rrdb, or with one RRDB, fold_ends gives way as in the
    reference."""
    _, _, sd, tm, x, _ = _trunk("3_blocks")
    calls = {}
    names = ("fused_dense_block", "fused_dense_block_prologue",
             "fused_dense_block_epilogue", "fused_rrdb")
    from superresolution_tpu_torch.infer import fused_trunk as ft

    real = {n: getattr(ft, n) for n in names}

    def counting(n):
        def op(*a, **k):
            calls[n] = calls.get(n, 0) + 1
            return real[n](*a, **k)
        return op

    try:
        for n in names:
            setattr(ft, n, counting(n))
        xt = torch.from_numpy(x)
        for kw, want in (
                (dict(fold_ends=True), {"fused_dense_block_prologue": 1,
                                        "fused_dense_block": 7,
                                        "fused_dense_block_epilogue": 1}),
                (dict(chain_rrdb=True), {"fused_rrdb": 3}),
                (dict(chain_rrdb=True, fold_ends=True), {"fused_rrdb": 3}),
                ({}, {"fused_dense_block": 9})):
            calls.clear()
            make_fused_trunk(sd, tm, device="cpu", **kw)(xt)
            assert calls == want, (kw, calls)
        one = RRDBNet(**dict(TRUNKS["2_blocks"], num_blocks=1), features=C,
                      growth=G, upsampler="pixelshuffle", device="cpu")
        sd1 = {k: v for k, v in sd.items() if not k.startswith("body.1.")}
        calls.clear()
        make_fused_trunk(sd1, one, fold_ends=True, device="cpu")(xt)
        assert calls == {"fused_dense_block": 3}
    finally:
        for n in names:
            setattr(ft, n, real[n])


def test_end_conv_weights_keep_the_params_dtype_on_the_cpu():
    """Kernels 4 and 5 on the CPU compute in the input's dtype with the
    params' own end-conv weights (f32 here), as the reference's end folds
    keep them; the dense blocks' stay bf16-rounded as in the default."""
    _, _, sd, tm, x, _ = _trunk("2_blocks")
    xt = torch.from_numpy(x)
    folded = make_fused_trunk(sd, tm, fold_ends=True, device="cpu")(xt)
    plain = make_fused_trunk(sd, tm, device="cpu")(xt)
    assert folded.dtype == torch.float32
    assert _rel(folded, plain) < TRUNK_TOL
    w = dt.dense_weights([hwio(torch.from_numpy(np.ones((4, 3, 3, 3),
                                                        np.float32)))],
                         [np.zeros(4, np.float32)])
    assert w[0][0].dtype == torch.bfloat16 and w[0][1].dtype == torch.float32
