"""Data x pipeline parallelism at 2 x 2 = 4 CPU ranks of a gloo process
group (superresolution_tpu_torch/parallel/pipeline.py with a 'data' axis,
and the Trainer on a data=2, pipe=2 mesh), against the JAX package and
the port's single-device Trainer.

Four ranks are spawned once for the file (parallel/launch.start_ranks, a
FileStore under tmp_path, a join timeout) and run both checks while
this process computes the reference's single-device objective (the
pipelined loss's function, by its docstring); each check is its own
case. Tolerances (f32 on the CPU): the loss 1e-5 rel and its gradients
1e-4 rel / 1e-5 abs (tests/test_pipeline_parallel.py's); the Trainer
against its single-device run 1e-4 rel / 1e-5 abs (the reference's
trainer tests')."""

import os

import numpy as np
import pytest
import torch

from superresolution_tpu_torch.parallel.launch import start_ranks

WORLD = 4
RRDB = dict(scale=2, in_channels=3, features=8, num_blocks=3, growth=4,
            upsampler="pixelshuffle")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors: intra-op threads gain nothing, and on a host
    loaded by parallel test workers their spin-waits cost several times
    the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


def _inputs():
    r = np.random.default_rng(11)
    return (r.random((8, 8, 8, 3), dtype=np.float32),
            r.random((8, 16, 16, 3), dtype=np.float32))


def _cfg(mesh):
    from superresolution_tpu_torch.utils.config import (
        Config,
        DataConfig,
        LossConfig,
        ModelConfig,
        TrainConfig,
    )

    # batch 8, 2 microbatches of 4, each split over the 2 data ranks
    return Config(
        name="dp_pp",
        model=ModelConfig(name="rrdbnet", scale=2, in_channels=1,
                          out_channels=1,
                          kwargs={"features": 8, "num_blocks": 3,
                                  "growth": 4}),
        data=DataConfig(hr_patch=16, batch_size=8, synthetic_len=8,
                        degradation="bicubic", augment=True, num_workers=1),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=1, lr=1e-3, eval_every=1,
                          preview_every=1000, precision="fp32",
                          resume=False),
        mesh=mesh)


def _fit(cfg, workdir):
    from superresolution_tpu_torch.train.trainer import Trainer

    with Trainer(cfg, workdir, device="cpu") as tr:
        out = tr.fit()
        return {"params": {k: v.numpy().copy()
                           for k, v in tr.state.params.items()},
                "psnr": out["best"]["psnr"], "shape": tr.mesh.shape}


def _rank_checks(rank, sd, workdir):
    """Both checks, in one order on every rank; a failing check returns
    its error instead of stopping the other."""
    import traceback

    from superresolution_tpu_torch.models.rrdbnet import RRDBNet
    from superresolution_tpu_torch.parallel.mesh import create_mesh
    from superresolution_tpu_torch.parallel.pipeline import (
        make_pipeline_loss,
    )
    from superresolution_tpu_torch.utils.config import MeshConfig

    os.environ["SRTPU_NO_TB"] = "1"

    def pipeline_loss():
        mesh = create_mesh(MeshConfig(data=2, pipe=2))
        m = RRDBNet(device="cpu", **RRDB)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        params = {k: p.detach().clone().requires_grad_()
                  for k, p in m.named_parameters()}
        lr, hr = (torch.from_numpy(a) for a in _inputs())
        loss = make_pipeline_loss(mesh, m, lambda p, t: (p - t).abs().sum(),
                                  n_micro=2)(params, lr, hr)
        grads = torch.autograd.grad(loss, list(params.values()))
        return {"loss": float(loss.detach()), "coords": mesh.coords,
                "grads": {k: g.numpy() for k, g in zip(params, grads)}}

    checks = {"pipeline_loss": pipeline_loss,
              "trainer": lambda: _fit(_cfg(MeshConfig(data=2, pipe=2)),
                                      os.path.join(workdir, f"r{rank}"))}
    out = {}
    for name, fn in checks.items():
        try:
            out[name] = ("ok", fn())
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out


def _jax_model():
    from superresolution_tpu.models.rrdbnet import RRDBNet as JRrdb

    return JRrdb(**RRDB, scan_blocks=True, fused_dense=True)


def _jax_params():
    """Variables of the reference's RRDBNet drawn with numpy in the
    shapes jax.eval_shape gives its init (no init program to compile)."""
    import jax
    import jax.numpy as jnp

    r = np.random.default_rng(12)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        scale = (1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
                 if name == "kernel" else 0.02)
        return (r.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        _jax_model().init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 8, 8, 3), jnp.float32)))


def _state_dict(tree):
    from superresolution_tpu_torch.models import convert

    return convert.rrdbnet_state_dict_from_jax(tree, num_blocks=3,
                                               features=8, growth=4)


def _jax_loss_and_grads(params):
    """The reference's plain L1 objective (make_pipeline_loss's function),
    its value and gradients."""
    import jax
    import jax.numpy as jnp

    model = _jax_model()
    lr, hr = (jnp.asarray(a) for a in _inputs())

    def plain(q):
        return jnp.sum(jnp.abs(model.apply(q, lr) - hr)) / hr.size

    loss, g = jax.jit(jax.value_and_grad(plain))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), _state_dict(jax.tree.map(np.asarray, g))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's results, the reference's loss and gradients): the
    ranks run while this process computes the reference."""
    params = _jax_params()
    work = str(tmp_path_factory.mktemp("dp_pp"))
    started = start_ranks(_rank_checks, WORLD, "gloo",
                          os.path.join(work, "pg"),
                          args=(_state_dict(params), work), timeout=240.0)
    loss, grads = _jax_loss_and_grads(params)
    return started.wait(), loss, grads


def _result(run, name, rank):
    status, value = run[0][rank][name]
    assert status == "ok", value
    return value


def test_dp_pp_pipeline_loss_matches_reference(run):
    """make_pipeline_loss on a 2 x 2 mesh (each microbatch's rows split
    over the data ranks, the 3 RRDBs over the pipe ranks as 2 + 1): the
    loss and every gradient equal the reference's plain objective on
    every rank."""
    _, loss, grads = run
    coords = []
    for rank in range(WORLD):
        got = _result(run, "pipeline_loss", rank)
        coords.append((got["coords"]["data"], got["coords"]["pipe"]))
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, grads[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_dp_pp_trainer_matches_single_device(run, tmp_path):
    """The Trainer on mesh data=2, pipe=2 (augmentation draws, a
    data-parallel evaluation) equals its single-device run: the params
    after the epoch on every rank and the validation PSNR."""
    from superresolution_tpu_torch.utils.config import MeshConfig

    single = _fit(_cfg(MeshConfig(data=1, spatial=1)), str(tmp_path))
    for rank in range(WORLD):
        got = _result(run, "trainer", rank)
        assert got["shape"] == {"data": 2, "pipe": 2}
        for k, v in single["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["psnr"], single["psnr"], rtol=1e-5)
