"""Kernel 9's arithmetic (superresolution_tpu_torch/utils/oca_forms.py)
against the JAX package's flash_oca_gathered in interpret mode, and
kernel 19's grid (utils/dma_probe.py), on the CPU, where the CUDA
kernels cannot run.

oca_tiled follows the kernel's order (key tiles, online softmax, p
rounded to the input type before the final division, heads zero-padded
to 16 or 24 columns): f32 within 1e-5 of max |ref| and bf16 within 0.03,
at head dim 16 and 20, B >= 2, tiles that divide ows^2 and tiles that do
not; each fault the chip check plants in the kernel, modelled here, moves
the output by more than 3x that bar. The grid covers every 16-byte word
exactly once, and the planted fault leaves exactly the last band."""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.ops import pallas_flash_oca as joca
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops import flash_oca
from superresolution_tpu_torch.utils import dma_probe as dp
from superresolution_tpu_torch.utils import oca_forms as of

# (B, H, W, C, heads, ws, ows): head dim 16 at ws 4 / ows 6 and at the
# hybrid's ws 8 / ows 12; head dim 20 (C 40, 2 heads) at ws 4 / ows 8
GEOMS = {"hd16_ws4": (2, 8, 12, 32, 2, 4, 6),
         "hd16_ws8": (2, 16, 8, 32, 2, 8, 12),
         "hd20_ws4": (3, 4, 8, 40, 2, 4, 8)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(geom, seed=0, q_scale=1.5, bias_scale=1.0):
    b, h, w, c, nh, ws, ows = GEOMS[geom]
    rng = np.random.default_rng(seed)
    pad = (ows - ws) // 2
    q = q_scale * rng.standard_normal(
        (b * (h // ws) * (w // ws), ws * ws, c))

    def kv_map():  # zero-padded after the dense, as the OCAB pads it
        m = 1.5 * rng.standard_normal((b, h, w, c))
        return np.pad(m, ((0, 0), (pad, pad), (pad, pad), (0, 0)))

    k_map, v_map = kv_map(), kv_map()
    bias = bias_scale * rng.standard_normal((nh, ws * ws, ows * ows))
    return [a.astype(np.float32) for a in (q, k_map, v_map, bias)]


@functools.lru_cache(maxsize=None)
def _jax(geom, dtype):
    _, _, _, _, nh, ws, ows = GEOMS[geom]
    q, k_map, v_map, bias = _inputs(geom)
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = joca.flash_oca_gathered(
        jnp.asarray(q, jt), jnp.asarray(k_map, jt), jnp.asarray(v_map, jt),
        jnp.asarray(bias), nh, ws, ows, True)
    return np.asarray(out.astype(jnp.float32))


def _form(geom, dtype, kt, plant=0, **scales):
    _, _, _, _, nh, ws, ows = GEOMS[geom]
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k_map, v_map, bias = (torch.from_numpy(a) for a in _inputs(
        geom, **scales))
    return of.oca_tiled(q.to(tt), k_map.to(tt), v_map.to(tt), bias, nh, ws,
                        ows, kt=kt, plant=plant)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("geom,kt", [
    ("hd16_ws4", 16),    # 36 keys: 16 + 16 + 4
    ("hd16_ws4", 48),    # one tile
    ("hd16_ws8", 48),    # 144 = 3 x 48
    ("hd16_ws8", 32),    # the kernel's tile: 144 = 4 x 32 + 16
    ("hd20_ws4", 16),    # 64 = 4 x 16
    ("hd20_ws4", 24),    # 64 = 2 x 24 + 16
])
def test_tiled_form_matches_jax_f32(geom, kt):
    got = _form(geom, "f32", kt)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), _jax(geom, "f32")) < 1e-5


@pytest.mark.parametrize("geom", ["hd16_ws8", "hd20_ws4"])
def test_tiled_form_matches_jax_bf16(geom):
    got = _form(geom, "bf16", 16)
    assert got.dtype == torch.bfloat16
    ref = _jax(geom, "bf16")
    assert _rel(got.float().numpy(), ref) < 0.03
    # and the kernel's own f32 arithmetic, which it rounds less
    assert _rel(got.float().numpy(), _jax(geom, "f32")) < 0.03


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_tiled_form_matches_plain_version(geom):
    _, _, _, _, nh, ws, ows = GEOMS[geom]
    args = [torch.from_numpy(a) for a in _inputs(geom, seed=1)]
    ref = flash_oca.flash_oca_gathered_reference(*args, nh, ws, ows)
    assert _rel(of.oca_tiled(*args, nh, ws, ows, kt=16).numpy(),
                ref.numpy()) < 1e-5


@pytest.mark.parametrize("plant", [_build.PLANT_PAD_MASKED,
                                   _build.PLANT_NO_RESCALE,
                                   _build.PLANT_ROW_STRIDE])
@pytest.mark.parametrize("geom", ["hd16_ws8", "hd20_ws4"])
def test_planted_faults_miss_the_bar(geom, plant):
    """At several key tiles and the chip check's scales for its fault
    inputs (q, k N(0, 1), bias N(0, 9)), each planted fault misses the
    0.03 bar by 3x or more, where the unplanted form meets it."""
    scales = dict(q_scale=1.0, bias_scale=3.0)
    ref = _form(geom, "f32", 16, **scales).numpy()
    assert _rel(_form(geom, "bf16", 16, **scales).float().numpy(),
                ref) < 0.03
    assert _rel(_form(geom, "bf16", 16, plant, **scales).float().numpy(),
                ref) > 3 * 0.03


def test_head_layout_pads_with_zeros():
    t = torch.arange(2 * 40, dtype=torch.float32).reshape(2, 40)
    lay = of.head_layout(t, 2)
    assert lay.shape == (2, 2, 24)
    assert torch.equal(lay[..., :20], t.reshape(2, 2, 20))
    assert not lay[..., 20:].any()


@pytest.mark.parametrize("m", [100, 144])   # ows 10 (padded to 104), 12
def test_bias_fragments_order(m):
    """Lane 4 g + t of head h, query tile qt, key n-tile kn holds rows
    16 qt + g (+ 8), keys 8 kn + 2 t (+ 1): the accumulator's layout, of
    the bias / scale."""
    nh, n = 2, 32
    bias = torch.randn(nh, n, m)
    frag = flash_oca.bias_fragments(bias * 0.25, 0.25).reshape(
        nh, n // 16, -(-m // 8), 32, 4)
    for h, qt, kn, lane in ((1, 1, 3, 13), (0, 0, (m - 1) // 8, 31),
                            (1, 0, 0, 0), (0, 1, (m - 1) // 8, 2)):
        g, t = divmod(lane, 4)
        rows, key = (16 * qt + g, 16 * qt + g + 8), 8 * kn + 2 * t
        want = [bias[h, r, key + e] if key + e < m else 0.0
                for r in rows for e in (0, 1)]
        assert torch.equal(frag[h, qt, kn, lane], torch.tensor(want))


@pytest.mark.parametrize("m", [36, 64])
def test_bias_fragments_hold_each_value_once(m):
    """The re-lay is a permutation of bias / scale, with zeros past m."""
    bias = torch.randn(3, 16, m)
    frag = flash_oca.bias_fragments(bias, 0.5)
    assert frag.numel() == 3 * 16 * -(-m // 8) * 8
    vals = frag[frag != 0]
    assert vals.numel() == bias.numel()
    assert torch.equal(vals.sort().values, (bias / 0.5).flatten().sort()
                       .values)


def test_copy_chunk_is_the_kernels():
    """COPY_CHUNK, by which copy_grid sizes the grid, is copy_kernel's
    chunk: COPY_WORDS 16-byte words for each of its COPY_THREADS (the
    launch fails on any other grid)."""
    src = (_build.SRC_DIR / "stream_kernels.cu").read_text()
    threads, words = (int(re.search(rf"constexpr int {k} = (\d+);",
                                    src).group(1))
                      for k in ("COPY_THREADS", "COPY_WORDS"))
    assert dp.COPY_CHUNK == threads * words * dp.WORD


@pytest.mark.parametrize("nbytes", [
    *(int(np.prod(shape)) * size for _, shape in dp.PROBE_SHAPES
      for size in (2, 4)),
    16, 16 * 1001, dp.COPY_CHUNK, dp.COPY_CHUNK + 16,
    16 * (65536 * 3 + 5)])
def test_copy_grid_covers_every_word_once(nbytes):
    """Block b copies bytes [b COPY_CHUNK, (b + 1) COPY_CHUNK) of the
    buffer: on copy_grid's grid each 16-byte word lies in one block, and
    no block lies past the end."""
    blocks = dp.copy_grid(nbytes)
    assert (blocks - 1) * dp.COPY_CHUNK < nbytes <= blocks * dp.COPY_CHUNK


@pytest.mark.parametrize("shape,rb", [((2, 12, 8, 16), 4),
                                      ((24, 376, 272, 64), 94)])
def test_planted_band_is_the_last_band(shape, rb):
    """The planted fault leaves the last band_bytes of the buffer
    unwritten, the band_bytes passthrough passes: rows [H - rb, H) of
    the last image, x[-1, -rb:], and no other."""
    b, h, w, c = shape
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    nbytes, band = x.numel() * 2, rb * w * c * 2
    assert x[-1, -rb:].storage_offset() * 2 == nbytes - band
    assert x[-1, -rb:].numel() * 2 == band
