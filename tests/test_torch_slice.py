"""Guard rails of the PyTorch port's first slice (the ESRGAN RRDBNet x4
tiled deploy path): the whole slice against the JAX package at a small
size, the port's independence from JAX, and its device rules (run on the
card unless the CPU is asked for; kernel wrappers never fall back)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.infer import tiled_device as jtiled
from superresolution_tpu.infer.fused_trunk import (
    fused_rrdb_model as jax_fused_rrdb_model,
)
from superresolution_tpu.models import RRDBNet as JaxRRDBNet
from superresolution_tpu_torch.infer.folded_tail import make_folded_tail
from superresolution_tpu_torch.infer.fused_trunk import (
    fused_rrdb_model,
    make_fused_trunk,
)
from superresolution_tpu_torch.infer.phase_tail import make_phase_tail
from superresolution_tpu_torch.infer.tiled_device import (
    make_tiled_infer_staged,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.ops import _build
from superresolution_tpu_torch.ops.dense_trunk import fused_dense_block
from superresolution_tpu_torch.ops.phase_tail import (
    conv_last_phase,
    up2_hr,
)
from superresolution_tpu_torch.runtime import resolve_device

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "superresolution_tpu_torch"


def _small(seed=0):
    jm = JaxRRDBNet(scale=4, in_channels=3, out_channels=3, features=16,
                    num_blocks=1, growth=8, upsampler="pixelshuffle")
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    sd = convert.rrdbnet_state_dict_from_jax(variables, num_blocks=1,
                                             features=16, growth=8)
    tm = RRDBNet(scale=4, features=16, num_blocks=1, growth=8,
                 upsampler="pixelshuffle", device="cpu")
    return jm, variables, sd, tm


def test_slice_matches_jax():
    """fused_rrdb_model through the tiled runner, port vs JAX."""
    jm, variables, sd, tm = _small()
    img = np.random.default_rng(0).random((16, 20, 3), np.float32)
    kw = dict(scale=4, tile=(8, 10), halo=2, tail_batch=2, h=16, w=20,
              channels=3)
    jfn = jax_fused_rrdb_model(variables, jm)
    ref = np.asarray(jtiled.make_tiled_infer_staged(
        lambda x: x, lambda x: jfn.apply(None, x), **kw)(img))
    got = make_tiled_infer_staged(
        lambda x: x, fused_rrdb_model(sd, tm, device="cpu"), device="cpu",
        **kw)(img).numpy()
    assert got.shape == ref.shape == (64, 80, 3)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-4


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "superresolution_tpu"), (f, name)


def test_entry_points_need_a_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    _, _, sd, tm = _small()
    entries = [
        lambda d: resolve_device(d),
        lambda d: RRDBNet(features=8, num_blocks=1, growth=4,
                          upsampler="pixelshuffle", device=d),
        lambda d: make_fused_trunk(sd, tm, device=d),
        lambda d: make_phase_tail(sd, device=d),
        lambda d: make_folded_tail(sd, device=d),
        lambda d: fused_rrdb_model(sd, tm, device=d),
        lambda d: make_tiled_infer_staged(lambda x: x, lambda x: x, 1, 4, 1,
                                          1, 8, 8, 1, device=d),
    ]
    for entry in entries:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(None)
        with pytest.raises(RuntimeError):
            entry("cuda")
        entry("cpu")


def test_kernel_wrappers_raise_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never taken for it."""
    m = torch.device("meta")
    x = torch.empty(1, 4, 4, 16, device=m)
    ws = [(torch.empty(3, 3, 16 + 8 * j, 8 if j < 4 else 16, device=m),
           torch.empty(8 if j < 4 else 16, device=m)) for j in range(5)]
    with pytest.raises(ValueError, match="CUDA"):
        fused_dense_block(x, ws)
    z1 = torch.empty(1, 4, 4, 64, device=m)
    with pytest.raises(ValueError, match="CUDA"):
        up2_hr(z1, torch.empty(3, 3, 16, 64, device=m),
               torch.empty(64, device=m), torch.empty(3, 3, 16, 16, device=m),
               torch.empty(16, device=m))
    with pytest.raises(ValueError, match="CUDA"):
        conv_last_phase(x, torch.empty(3, 3, 16, 3, device=m),
                        torch.empty(3, device=m))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and proc.stdout.strip() == ""


def test_fused_rrdb_model_x2_standard_tail_matches_jax():
    """A x2 pixelshuffle tail (the hybrid's stage 1) is not the phase
    tail's x4 layout: the fused trunk runs, then the model's standard
    tail as plain convs, as in the reference."""
    kw = dict(scale=2, in_channels=1, out_channels=1, features=16,
              num_blocks=1, growth=8, upsampler="pixelshuffle")
    jm = JaxRRDBNet(**kw)
    variables = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8, 8, 1)))
    sd = convert.rrdbnet_state_dict_from_jax(variables, num_blocks=1,
                                             features=16, growth=8)
    x = np.random.default_rng(1).random((2, 10, 12, 1), np.float32)
    ref = np.asarray(jax_fused_rrdb_model(variables, jm).apply(
        None, jnp.asarray(x)))
    got = fused_rrdb_model(sd, RRDBNet(**kw, device="cpu"), device="cpu")(
        torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 20, 24, 1)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
