"""The port's parallel/ package (superresolution_tpu_torch/parallel/) and
its wiring into the train steps, the Trainer and the staged tiler, on 2
CPU ranks of a gloo process group, against the JAX package.

Two ranks are spawned once for the whole file (parallel/launch.run_ranks,
a FileStore under tmp_path, a join timeout); they run every check below
and return their results, and each check is reported as its own case.
The JAX side runs in this process: at most one multi-device program of
each parallel function (on tests/conftest.py's 8-device CPU mesh, cut to
2), every other case against the reference's single-device result,
which those functions' objectives equal. Weights cross from JAX through
models/convert.py; inputs are made with numpy from a seed.

Tolerances (f32 on the CPU): the data-parallel steps' params 1e-5 rel /
1e-6 abs and their losses 1e-5 (tests/test_parallel.py's); the tiled
mesh 2e-5 (tests/test_mesh_tiled.py's); the spatial loss 1e-5 rel, its
gradients 1e-4 rel / 1e-6 abs (tests/test_parallel.py's); the pipelines
1e-5 (tests/test_pipeline_parallel.py's), their gradients 1e-4 rel /
1e-5 abs; a port result against the port's own single-device run 1e-5
(the trainers: 1e-4 rel / 1e-5 abs, as the reference's trainer tests).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from superresolution_tpu_torch.parallel.launch import start_ranks
from superresolution_tpu_torch.parallel.mesh import Mesh, create_mesh

WORLD = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU tensors: intra-op threads gain nothing, and on a host
    loaded by parallel test workers their spin-waits cost several times
    the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs, made the same way in the ranks and here
# ---------------------------------------------------------------------------

def _rng(k):
    return np.random.default_rng(100 + k)


def _dp_batch():
    return {"hr": _rng(1).random((8, 16, 16, 1), dtype=np.float32)}


def _gan_batch():
    r = _rng(2)
    return {"hr": r.random((4, 32, 32, 1), dtype=np.float32),
            "lr": r.random((4, 16, 16, 1), dtype=np.float32)}


def _tiled_img(case):
    return _rng(3 + case).random(((64, 96, 1), (32, 80, 1))[case],
                                 dtype=np.float32)


def _spatial_inputs():
    r = _rng(5)
    return (r.random((1, 128, 32, 1), dtype=np.float32),
            r.random((1, 256, 64, 1), dtype=np.float32))


def _dense_stages():
    r = _rng(6)
    return ([{"w": (r.standard_normal((8, 8)) * 0.3).astype(np.float32),
              "b": (r.standard_normal(8) * 0.1).astype(np.float32)}
             for _ in range(WORLD)],
            r.standard_normal((3, 2, 8)).astype(np.float32),
            r.standard_normal((3, 2, 8)).astype(np.float32))


def _trunk_feats():
    return (_rng(7).standard_normal((3, 2, 8, 8, 8)) * 0.3).astype(
        np.float32)


def _hat_feats():
    return (_rng(8).standard_normal((2, 1, 16, 16, 12)) * 0.3).astype(
        np.float32)


def _pipe_loss_inputs():
    r = _rng(9)
    return (r.random((4, 8, 8, 3), dtype=np.float32),
            r.random((4, 16, 16, 3), dtype=np.float32))


def _dense_stage(sp, u):
    return torch.tanh(u @ sp["w"] + sp["b"])


def _t(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            sd.items()}


def _l1_sum(pred, hr):
    return (pred - hr).abs().sum()


def _espcn(sd):
    from superresolution_tpu_torch.models.espcn import ESPCN

    m = ESPCN(scale=2, in_channels=1, out_channels=1, f1=8, f2=8,
              device="cpu")
    m.load_state_dict(_t(sd))
    return m


def _rrdb(sd, **kw):
    from superresolution_tpu_torch.models.rrdbnet import RRDBNet

    m = RRDBNet(device="cpu", **kw)
    m.load_state_dict(_t(sd))
    return m


RRDB_DP = dict(scale=2, in_channels=1, out_channels=1, features=16,
               num_blocks=1, growth=8, upsampler="pixelshuffle")
RRDB_PIPE = dict(scale=2, in_channels=3, features=8, num_blocks=5,
                 growth=4, upsampler="pixelshuffle")
HAT = dict(scale=2, in_channels=1, out_channels=1, embed_dim=12,
           depths=(2, 2, 2), num_heads=(3, 3, 3), window_size=4)


def _step_parts(model, accum=1, apply_fn=None, mesh=None, gan=None):
    """A port train step (or GAN step) at the reference tests' settings:
    AdamW lr 1e-3 fp32, l1, bicubic input without augmentation."""
    from superresolution_tpu_torch.losses.combined import CombinedLoss
    from superresolution_tpu_torch.train.gan import make_gan_steps
    from superresolution_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )
    from superresolution_tpu_torch.train.steps import (
        make_device_input,
        make_train_step,
    )
    from superresolution_tpu_torch.utils.config import (
        DataConfig,
        LossConfig,
        TrainConfig,
    )
    from superresolution_tpu_torch.utils.precision import get_policy

    tx, _ = make_optimizer(TrainConfig(lr=1e-3, precision="fp32"), 100)
    input_fn = make_device_input(
        DataConfig(degradation="bicubic", augment=False), 2)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = create_train_state(params, tx)
    if gan is None:
        step = make_train_step(model, CombinedLoss(LossConfig()), tx,
                               get_policy("fp32"), input_fn,
                               accum_steps=accum, apply_fn=apply_fn,
                               mesh=mesh)
        return step, state
    d_params = {k: p.detach().clone() for k, p in gan.named_parameters()}
    d_tx, _ = make_optimizer(TrainConfig(lr=1e-3, precision="fp32"), 100)
    step = make_gan_steps(model, gan, CombinedLoss(LossConfig()), tx, d_tx,
                          get_policy("fp32"), input_fn, gan_weight=0.005,
                          accum_steps=accum, mesh=mesh)
    return step, state, create_train_state(d_params, d_tx), d_tx


def _np_params(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.items()}


def _np_logs(logs):
    return {k: float(v) for k, v in logs.items()}


def _trainer_cfg(mesh_cfg, name):
    from superresolution_tpu_torch.utils.config import (
        Config,
        DataConfig,
        LossConfig,
        ModelConfig,
        TrainConfig,
    )

    return Config(
        name=name,
        model=ModelConfig(name="rrdbnet", scale=2, in_channels=1,
                          out_channels=1,
                          kwargs={"features": 8, "num_blocks": 3,
                                  "growth": 4}),
        data=DataConfig(hr_patch=16, batch_size=4, synthetic_len=4,
                        degradation="bicubic", augment=True, num_workers=1),
        loss=LossConfig(terms={"l1": 1.0}),
        train=TrainConfig(epochs=1, lr=1e-3, eval_every=1,
                          preview_every=1000, precision="fp32",
                          resume=False, accum_steps=2),
        mesh=mesh_cfg)


def _run_trainer(cfg, workdir, mesh=None):
    from superresolution_tpu_torch.train.trainer import Trainer

    with Trainer(cfg, workdir, device="cpu", mesh=mesh) as tr:
        out = tr.fit()
        params = _np_params(tr.state)
        shape = tr.mesh.shape
    logs = []
    path = os.path.join(workdir, "logs", "metrics.jsonl")
    if os.path.exists(path):
        import json

        logs = [json.loads(line) for line in open(path)]
        for rec in logs:
            rec.pop("time", None)
            rec.pop("train/samples_per_sec", None)
    return {"params": params, "logs": logs, "psnr": out["best"]["psnr"],
            "shape": shape}


# ---------------------------------------------------------------------------
# the checks each rank runs
# ---------------------------------------------------------------------------

def _check_dp_step(sd, mesh, accum):
    step, state = _step_parts(_espcn(sd["espcn"]), accum=accum, mesh=mesh)
    b = _dp_batch()
    state, logs = step(state, {"hr": torch.from_numpy(b["hr"])}, None)
    return {"params": _np_params(state), "logs": _np_logs(logs)}


def _check_dp_fused(sd, mesh):
    from superresolution_tpu_torch.train.fused_apply import (
        make_fused_train_apply,
    )

    model = _rrdb(sd["rrdb_dp"], **RRDB_DP)
    step, state = _step_parts(model, apply_fn=make_fused_train_apply(model),
                              mesh=mesh)
    state, logs = step(state, {"hr": torch.from_numpy(_dp_batch()["hr"])},
                       None)
    return {"params": _np_params(state), "logs": _np_logs(logs)}


def _check_dp_gan(sd, mesh):
    from superresolution_tpu_torch.models.discriminator import (
        VGGStyleDiscriminator,
    )

    disc = VGGStyleDiscriminator(1, features=16, input_size=32,
                                 device="cpu")
    disc.load_state_dict(_t(sd["disc"]))
    step, g, d, d_tx = _step_parts(_espcn(sd["espcn"]), mesh=mesh, gan=disc)
    applied = {}
    update = d_tx.update_

    def spy(grads, opt_state, params):  # the gradient D's AdamW is handed
        applied.update({k: v.detach().numpy().copy()
                        for k, v in grads.items()})
        return update(grads, opt_state, params)

    d_tx.update_ = spy
    g, d, logs = step(g, d, {k: torch.from_numpy(v)
                             for k, v in _gan_batch().items()}, None)
    return {"params": _np_params(g), "d_params": _np_params(d),
            "d_grad": applied, "logs": _np_logs(logs)}


def _check_tiled(sd, mesh, case):
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged,
    )

    m = _rrdb(sd["rrdb_dp"], **RRDB_DP)
    img = _tiled_img(case)
    h, w, _ = img.shape
    kw = dict(tail_batch=2) if case == 0 else dict(tail_batch=4,
                                                   trunk_batch=5)
    run = make_tiled_infer_staged(m.trunk, m.tail, 2, 16, 8, h=h, w=w,
                                  channels=1, mesh=mesh, device="cpu", **kw)
    return run(torch.from_numpy(img)).numpy()


def _check_spatial_apply(sd, mesh):
    from superresolution_tpu_torch.parallel.spatial import (
        spatial_shard_apply,
    )

    m = _espcn(sd["espcn"])
    with torch.no_grad():
        return spatial_shard_apply(mesh, m, torch.from_numpy(
            _spatial_inputs()[0]), halo=8, scale=2).numpy()


def _check_spatial_loss(sd, mesh):
    from torch.func import functional_call

    from superresolution_tpu_torch.parallel.spatial import make_spatial_loss

    m = _espcn(sd["espcn"])
    lr, hr = (torch.from_numpy(a) for a in _spatial_inputs())
    lr.requires_grad_()
    params = {k: p.detach().clone().requires_grad_()
              for k, p in m.named_parameters()}
    loss_fn = make_spatial_loss(
        mesh, lambda p, x: functional_call(m, p, (x,)), _l1_sum, 8, 2)
    loss = loss_fn(params, lr, hr)
    grads = torch.autograd.grad(loss, list(params.values()) + [lr])
    return {"loss": float(loss.detach()),
            "grads": {k: g.numpy() for k, g in zip(params, grads)},
            "lr_grad": grads[-1].numpy()}


def _check_pipeline_apply(mesh):
    from superresolution_tpu_torch.parallel.pipeline import pipeline_apply

    stages, x, tgt = _dense_stages()
    sp = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()}
          for s in stages]
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(mesh, _dense_stage, sp, xt)
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    leaves = [t for s in sp for t in s.values()] + [xt]
    grads = torch.autograd.grad(loss, leaves)
    return {"out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def _check_trunk_pipeline(sd, mesh):
    from superresolution_tpu_torch.parallel.pipeline import (
        make_trunk_pipeline,
    )

    m = _rrdb(sd["rrdb_pipe"], **RRDB_PIPE)
    with torch.no_grad():
        return make_trunk_pipeline(mesh, m, m.state_dict())(
            torch.from_numpy(_trunk_feats())).numpy()


def _check_hat_pipeline(sd, mesh):
    from superresolution_tpu_torch.models.hat_lite import HATLite
    from superresolution_tpu_torch.parallel.pipeline import (
        make_hat_group_pipeline,
    )

    m = HATLite(device="cpu", **HAT)
    m.load_state_dict(_t(sd["hat"]))
    with torch.no_grad():
        return make_hat_group_pipeline(mesh, m, m.state_dict())(
            torch.from_numpy(_hat_feats())).numpy()


def _check_pipeline_loss(sd, mesh):
    from superresolution_tpu_torch.parallel.pipeline import (
        make_pipeline_loss,
    )

    m = _rrdb(sd["rrdb_pipe"], **RRDB_PIPE)
    lr, hr = (torch.from_numpy(a) for a in _pipe_loss_inputs())
    params = {k: p.detach().clone().requires_grad_()
              for k, p in m.named_parameters()}
    loss_fn = make_pipeline_loss(mesh, m, _l1_sum, n_micro=2)
    loss = loss_fn(params, lr, hr)
    grads = torch.autograd.grad(loss, list(params.values()))
    try:
        loss_fn(params, lr[:3], hr[:3])
        err = None
    except ValueError as e:
        err = str(e)
    return {"loss": float(loss.detach()), "err": err,
            "grads": {k: g.numpy() for k, g in zip(params, grads)}}


ANCHOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "assets", "quality", "port")


def _anchor_img():
    return _rng(10).random((16, 24, 3), dtype=np.float32)


def _check_cli(workdir, rank):
    """The command line under a process group (as torchrun runs it): train
    --mesh-data 2 and upscale --mesh-data 2 (the committed anchor, f32
    trunk and tail), with what each rank printed and the float image
    upscale hands save_png."""
    import contextlib
    import io

    from superresolution_tpu_torch.cli.main import main
    from superresolution_tpu_torch.data import io as tio

    src = os.path.join(workdir, "anchor_in.png")
    if rank == 0:
        tio.save_png(_anchor_img(), src)
    torch.distributed.barrier()
    saved = {}
    real = tio.save_png
    tio.save_png = lambda arr, path: saved.setdefault("img", np.array(arr))
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            main(["train", "--preset", "srcnn_x2", "--workdir",
                  os.path.join(workdir, "cli_train"), "--epochs", "1",
                  "--batch-size", "4", "--mesh-data", "2",
                  "--device", "cpu"])
            main(["upscale", "--input", src, "--output",
                  os.path.join(workdir, "cli_out.png"), "--ckpt", ANCHOR,
                  "--tile", "8", "--halo", "4", "--mesh-data", "2",
                  "--device", "cpu"])
    finally:
        tio.save_png = real
    return {"printed": printed.getvalue(), "img": saved.get("img")}


def _rank_checks(rank, sd, workdir):
    """Every check of this file, in one order on both ranks; a failing
    check returns its error instead of stopping the others."""
    import traceback

    from superresolution_tpu_torch.utils.config import MeshConfig

    os.environ["SRTPU_NO_TB"] = "1"
    dp = create_mesh(MeshConfig(data=WORLD, spatial=1))
    sp = create_mesh(MeshConfig(data=1, spatial=WORLD))
    pp = create_mesh(MeshConfig(data=1, pipe=WORLD))
    checks = {
        "dp_step": lambda: _check_dp_step(sd, dp, 1),
        "dp_step_accum": lambda: _check_dp_step(sd, dp, 2),
        "dp_fused": lambda: _check_dp_fused(sd, dp),
        "dp_gan": lambda: _check_dp_gan(sd, dp),
        "dp_trainer": lambda: _run_trainer(
            _trainer_cfg(MeshConfig(data=WORLD, spatial=1), "dp"),
            os.path.join(workdir, f"dp{rank}")),
        "tiled_mesh": lambda: _check_tiled(sd, dp, 0),
        "tiled_mesh_trunk_batch": lambda: _check_tiled(sd, dp, 1),
        "spatial_apply": lambda: _check_spatial_apply(sd, sp),
        "spatial_loss": lambda: _check_spatial_loss(sd, sp),
        "pipeline_apply": lambda: _check_pipeline_apply(pp),
        "trunk_pipeline": lambda: _check_trunk_pipeline(sd, pp),
        "hat_group_pipeline": lambda: _check_hat_pipeline(sd, pp),
        "pipeline_loss": lambda: _check_pipeline_loss(sd, pp),
        "pipe_trainer": lambda: _run_trainer(
            _trainer_cfg(MeshConfig(data=1, pipe=WORLD), "pp"),
            os.path.join(workdir, f"pp{rank}")),
        "cli": lambda: _check_cli(workdir, rank),
    }
    out = {}
    for name, fn in checks.items():
        try:
            out[name] = ("ok", fn())
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out


# ---------------------------------------------------------------------------
# the JAX side, and the spawn
# ---------------------------------------------------------------------------

def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _random_tree(shapes, seed):
    """Variables of the shapes jax.eval_shape gives an init, drawn with
    numpy (no init program to compile): kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1), everything else N(0, 0.02)."""
    import jax

    r = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            v = 1.0 + 0.1 * r.standard_normal(leaf.shape)
        elif name == "kernel":
            v = r.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        else:
            v = 0.02 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.cache
def _jax_models():
    """The JAX models, their variables, and the state dicts the ranks
    load (models/convert.py)."""
    import jax
    import jax.numpy as jnp

    from superresolution_tpu.models import ESPCN as JEspcn
    from superresolution_tpu.models.discriminator import (
        VGGStyleDiscriminator as JDisc,
    )
    from superresolution_tpu.models.hat_lite import HATLite as JHat
    from superresolution_tpu.models.rrdbnet import RRDBNet as JRrdb
    from superresolution_tpu_torch.models import convert

    m = {"espcn": JEspcn(scale=2, in_channels=1, out_channels=1, f1=8,
                         f2=8),
         "disc": JDisc(in_channels=1, features=16, input_size=32),
         "rrdb_dp": JRrdb(**RRDB_DP),
         "rrdb_pipe": JRrdb(**RRDB_PIPE, scan_blocks=True, fused_dense=True),
         "hat": JHat(**HAT, scan_blocks=True)}
    shapes = {"espcn": (1, 16, 16, 1), "disc": (1, 32, 32, 1),
              "rrdb_dp": (1, 8, 8, 1), "rrdb_pipe": (1, 8, 8, 3),
              "hat": (1, 16, 16, 1)}
    p = {k: jax.tree.map(jnp.asarray, _random_tree(jax.eval_shape(
        m[k].init, jax.random.key(0),
        jax.ShapeDtypeStruct(shapes[k], jnp.float32)), i))
        for i, k in enumerate(shapes)}
    sd = {"espcn": convert.espcn_state_dict_from_jax(_np_tree(p["espcn"])),
          "disc": convert.discriminator_state_dict_from_jax(
              _np_tree(p["disc"])),
          "hat": convert.hat_state_dict_from_jax(_np_tree(p["hat"]),
                                                 depths=HAT["depths"])}
    for k, kw in (("rrdb_dp", RRDB_DP), ("rrdb_pipe", RRDB_PIPE)):
        sd[k] = convert.rrdbnet_state_dict_from_jax(
            _np_tree(p[k]), num_blocks=kw["num_blocks"],
            features=kw["features"], growth=kw["growth"])
    return m, p, sd


def _jax_mesh(**kw):
    import jax

    from superresolution_tpu.parallel import create_mesh as jax_mesh
    from superresolution_tpu.utils.config import MeshConfig

    n = kw.get("data", 1) * kw.get("spatial", 1)
    return jax_mesh(MeshConfig(**kw), devices=jax.devices()[:n])


def _jax_dp_step(kind):
    """The reference's train step (tests/test_parallel.py's) on a 2-device
    data mesh, fused through make_fused_train_apply_dp (interpret mode)
    for the RRDBNet -> (params as a torch state dict, logs)."""
    import jax

    from superresolution_tpu.losses.combined import CombinedLoss
    from superresolution_tpu.parallel import shard_batch
    from superresolution_tpu.train.state import (
        create_train_state,
        make_optimizer,
    )
    from superresolution_tpu.train.steps import (
        make_device_input,
        make_train_step,
    )
    from superresolution_tpu.utils.config import (
        DataConfig,
        LossConfig,
        TrainConfig,
    )
    from superresolution_tpu.utils.precision import get_policy
    from superresolution_tpu_torch.models import convert

    models, params, _ = _jax_models()
    model = models[kind]
    tx, _ = make_optimizer(TrainConfig(lr=1e-3, precision="fp32"), 100)
    mesh = _jax_mesh(data=2, spatial=1)
    apply_fn = None
    if kind == "rrdb_dp":
        from superresolution_tpu.train.fused_apply import (
            make_fused_train_apply_dp,
        )

        apply_fn = make_fused_train_apply_dp(model, mesh, interpret=True)
    step = make_train_step(model, CombinedLoss(LossConfig()), tx,
                           get_policy("fp32"),
                           make_device_input(DataConfig(
                               degradation="bicubic", augment=False), 2),
                           apply_fn=apply_fn)
    state, logs = jax.jit(step)(create_train_state(params[kind], tx),
                                shard_batch(mesh, _dp_batch()),
                                jax.random.key(5))
    p = _np_tree(state.params)
    sd = (convert.espcn_state_dict_from_jax(p) if kind == "espcn" else
          convert.rrdbnet_state_dict_from_jax(p, num_blocks=1, features=16,
                                              growth=8))
    return {"params": sd, "logs": {k: float(v) for k, v in logs.items()}}


def _jax_gan_step():
    """The reference's single-device GAN step on _gan_batch."""
    import jax
    import jax.numpy as jnp

    from superresolution_tpu.losses.combined import CombinedLoss
    from superresolution_tpu.train.gan import make_gan_steps
    from superresolution_tpu.train.state import (
        create_train_state,
        make_optimizer,
    )
    from superresolution_tpu.train.steps import make_device_input
    from superresolution_tpu.utils.config import (
        DataConfig,
        LossConfig,
        TrainConfig,
    )
    from superresolution_tpu.utils.precision import get_policy
    from superresolution_tpu_torch.models import convert

    models, params, _ = _jax_models()
    tx, _ = make_optimizer(TrainConfig(lr=1e-3, precision="fp32"), 100)
    step = make_gan_steps(models["espcn"], models["disc"],
                          CombinedLoss(LossConfig()), tx, tx,
                          get_policy("fp32"),
                          make_device_input(DataConfig(
                              degradation="bicubic", augment=False), 2),
                          gan_weight=0.005)
    g, d, logs = jax.jit(step)(
        create_train_state(params["espcn"], tx),
        create_train_state(params["disc"], tx),
        {k: jnp.asarray(v) for k, v in _gan_batch().items()},
        jax.random.key(5))
    return {"params": convert.espcn_state_dict_from_jax(_np_tree(g.params)),
            "d_params": convert.discriminator_state_dict_from_jax(
                _np_tree(d.params)),
            "logs": {k: float(v) for k, v in logs.items()}}


def _jax_tiled():
    """The reference's make_tiled_infer_staged on a 2-device data mesh
    (tests/test_mesh_tiled.py's first case)."""
    import jax.numpy as jnp

    from superresolution_tpu.infer import make_tiled_infer_staged

    models, params, _ = _jax_models()
    m, p = models["rrdb_dp"], params["rrdb_dp"]
    img = _tiled_img(0)
    h, w, _ = img.shape
    run = make_tiled_infer_staged(
        lambda t: m.apply(p, t, method="trunk"),
        lambda f: m.apply(p, f, method="tail"), 2, 16, 8, tail_batch=2,
        h=h, w=w, channels=1, mesh=_jax_mesh(data=2, spatial=1))
    return np.asarray(run(jnp.asarray(img)))


def _jax_spatial():
    """The reference's spatial_shard_apply on a 2-device spatial mesh, and
    the value and gradients (params, lr) of make_spatial_loss's
    single-device objective (zero-halo pad, crop)."""
    import jax
    import jax.numpy as jnp

    from superresolution_tpu.parallel import spatial_shard_apply
    from superresolution_tpu_torch.models import convert

    models, params, _ = _jax_models()
    model, p = models["espcn"], params["espcn"]
    lr, hr = (jnp.asarray(a) for a in _spatial_inputs())
    apply = np.asarray(spatial_shard_apply(
        _jax_mesh(data=1, spatial=2), lambda x: model.apply(p, x), lr,
        halo=8, scale=2))

    def ref_loss(q, x):
        xp = jnp.pad(x, ((0, 0), (8, 8), (0, 0), (0, 0)))
        out = model.apply(q, xp)[:, 16:-16]
        return jnp.sum(jnp.abs(out - hr)) / hr.size

    loss, (gp, gx) = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1)))(
        p, lr)
    return {"apply": apply, "loss": float(loss), "lr_grad": np.asarray(gx),
            "grads": convert.espcn_state_dict_from_jax(_np_tree(gp))}


def _jax_pipelines():
    """The reference's pipelined RRDB trunk on a 2-device pipe mesh, its
    sequential HATLite group loop, and the value and gradients of the
    plain L1 objective make_pipeline_loss equals."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from superresolution_tpu.models.hat_lite import ResidualGroup
    from superresolution_tpu.parallel.pipeline import make_trunk_pipeline
    from superresolution_tpu_torch.models import convert

    models, params, _ = _jax_models()
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("pipe",))
    trunk = np.asarray(jax.jit(make_trunk_pipeline(
        mesh, models["rrdb_pipe"], params["rrdb_pipe"]))(
            jnp.asarray(_trunk_feats())))

    m = models["hat"]
    rg = ResidualGroup(12, 2, 3, 4, mlp_ratio=m.mlp_ratio,
                       conv_scale=m.conv_scale,
                       overlap_ratio=m.overlap_ratio, scan_blocks=True)

    @jax.jit
    def groups_in_turn(groups, feats):
        def body(u, w):
            return rg.apply({"params": w["ResidualGroup_0"]}, u), None

        return jax.vmap(lambda u: jax.lax.scan(body, u, groups)[0])(feats)

    hat = np.asarray(groups_in_turn(params["hat"]["params"]["groups"],
                                    jnp.asarray(_hat_feats())))
    lr, hr = (jnp.asarray(a) for a in _pipe_loss_inputs())

    def plain(q):
        return jnp.sum(jnp.abs(models["rrdb_pipe"].apply(q, lr) - hr)) \
            / hr.size

    loss, g = jax.jit(jax.value_and_grad(plain))(params["rrdb_pipe"])
    return {"trunk": trunk, "hat": hat, "loss": float(loss),
            "grads": convert.rrdbnet_state_dict_from_jax(
                _np_tree(g), num_blocks=5, features=8, growth=4)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(both ranks' results, the JAX references): the ranks are spawned
    once for the file and run while this process computes the
    references."""
    _, _, sd = _jax_models()
    work = str(tmp_path_factory.mktemp("ranks"))
    started = start_ranks(_rank_checks, WORLD, "gloo",
                          os.path.join(work, "pg"), args=(sd, work),
                          timeout=300.0)
    refs = {"dp_step": _jax_dp_step("espcn"),
            "dp_fused": _jax_dp_step("rrdb_dp"),
            "dp_gan": _jax_gan_step(), "tiled": _jax_tiled(),
            "spatial": _jax_spatial(), "pipe": _jax_pipelines()}
    return started.wait(), refs


def _result(run, name, rank=0):
    status, value = run[0][rank][name]
    assert status == "ok", value
    return value


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


ONE = Mesh(("data", "spatial"), (1, 1))


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


@pytest.mark.parametrize("case", ["dp_step", "dp_step_accum", "dp_fused"])
def test_dp_step_matches_reference(run, case):
    """The 2-rank data-parallel step: the params after the step and the
    logs equal the port's single-device step, and the reference's DP
    step on a 2-device data mesh (fused: through make_fused_train_apply_dp
    in interpret mode). The accumulating case (each rank its rows of
    both micro-batches) is held to the port's single-device step, which
    tests/test_torch_train_step.py holds to the reference's."""
    got, other = _result(run, case), _result(run, case, rank=1)
    sd = _jax_models()[2]
    if case == "dp_fused":
        single = _check_dp_fused(sd, None)
    else:
        single = _check_dp_step(sd, None, 2 if case == "dp_step_accum"
                                else 1)
    want = run[1].get(case)
    for k, v in got["params"].items():
        np.testing.assert_array_equal(v, other["params"][k])
        _close(v, single["params"][k])
        if want is not None:
            _close(v, want["params"][k])
    for k in ("total", "l1", "grad_norm"):
        _close(got["logs"][k], single["logs"][k], atol=1e-5)
        if want is not None:
            _close(got["logs"][k], want["logs"][k], atol=1e-5)


def _assert_d_step_close(got, want, grad):
    """D's params after its first AdamW step, by tests/test_torch_gan.py's
    rule: that step moves a param by lr * g / (|g| + 1e-8), which f32
    noise in g moves by up to 2 lr where |g| < 1e-5; those params are
    held to 2 lr = 2e-3, the rest to 1e-5."""
    tight = np.abs(grad) > 1e-5
    np.testing.assert_allclose(got[tight], want[tight], atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_dp_gan_step_matches_reference(run):
    """The 2-rank GAN step (two rows a rank, the relativistic losses over
    the gathered logits of all four) equals the port's
    single-device step and the reference's single-device GAN step: G's
    params and the logs within 1e-5, D's gradient within 1e-5 of its
    max, and D's params after the step by _assert_d_step_close."""
    got = _result(run, "dp_gan")
    single = _check_dp_gan(_jax_models()[2], None)
    want = run[1]["dp_gan"]
    for k, v in got["params"].items():
        _close(v, single["params"][k])
        _close(v, want["params"][k])
    g_max = max(float(np.abs(v).max()) for v in single["d_grad"].values())
    for k, v in got["d_params"].items():
        grad = single["d_grad"][k]
        _close(got["d_grad"][k], grad, rtol=0, atol=1e-5 * g_max)
        _assert_d_step_close(v, single["d_params"][k], grad)
        _assert_d_step_close(v, want["d_params"][k], grad)
    for k in ("d_loss", "g_adv", "g_total", "l1"):
        _close(got["logs"][k], single["logs"][k], atol=1e-5)
        _close(got["logs"][k], want["logs"][k], atol=1e-5)


@pytest.mark.parametrize("case", ["dp_trainer", "pipe_trainer"])
def test_trainer_matches_single_device(run, tmp_path, case):
    """The port's Trainer at mesh.data = 2 (augmentation draws, accum 2,
    a data-parallel evaluation) or mesh.pipe = 2 equals its single-device
    run on the same config: the params after the epoch on both ranks,
    rank 0's logs (train and val), and nothing logged by rank 1."""
    from superresolution_tpu_torch.utils.config import MeshConfig

    got, other = _result(run, case), _result(run, case, rank=1)
    assert got["shape"] == ({"data": 2, "spatial": 1} if case == "dp_trainer"
                            else {"data": 1, "pipe": 2})
    single = _run_trainer(_trainer_cfg(MeshConfig(data=1, spatial=1), "one"),
                          str(tmp_path))
    for k, v in single["params"].items():
        _close(got["params"][k], v, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got["params"][k], other["params"][k])
    assert other["logs"] == []
    assert [sorted(r) for r in got["logs"]] == \
        [sorted(r) for r in single["logs"]]
    for a, b in zip(got["logs"], single["logs"]):
        for k in a:
            _close(a[k], b[k], rtol=1e-4, atol=1e-5)
    _close(got["psnr"], single["psnr"], rtol=1e-5)


@pytest.mark.parametrize("case", [0, 1])
def test_tiled_mesh_matches_reference(run, case):
    """make_tiled_infer_staged(mesh=...) at 2 data ranks: case 0 (a 4x6
    grid, tail 2) equals the reference's 2-device mesh run; case 1, the
    explicit trunk_batch padding (a 2x5 grid, tail 4, trunk 5, padded to
    lcm(5, 8) = 40 tiles), equals the port's single-device staged tiler
    (held to the reference's by tests/test_torch_tiled_device.py)."""
    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged,
    )

    name = "tiled_mesh" if case == 0 else "tiled_mesh_trunk_batch"
    got = _result(run, name)
    np.testing.assert_array_equal(got, _result(run, name, rank=1))
    if case == 0:
        want = run[1]["tiled"]
    else:
        m = _rrdb(_jax_models()[2]["rrdb_dp"], **RRDB_DP)
        img = _tiled_img(1)
        h, w, _ = img.shape
        want = make_tiled_infer_staged(m.trunk, m.tail, 2, 16, 8,
                                       tail_batch=4, h=h, w=w, channels=1,
                                       device="cpu")(
            torch.from_numpy(img)).numpy()
    assert got.shape == want.shape
    _close(got, want, rtol=0, atol=2e-5)


def test_spatial_apply_matches_reference(run):
    """spatial_shard_apply at 2 spatial ranks equals the reference's on a
    2-device spatial mesh everywhere (the same replicate edges), and the
    unsharded forward away from the halo*scale border."""
    got = _result(run, "spatial_apply")
    np.testing.assert_array_equal(got, _result(run, "spatial_apply", 1))
    want = run[1]["spatial"]["apply"]
    m = _espcn(_jax_models()[2]["espcn"])
    with torch.no_grad():
        full = m(torch.from_numpy(_spatial_inputs()[0])).numpy()
    assert got.shape == want.shape == full.shape
    _close(got, want, rtol=0, atol=2e-5)
    _close(got[:, 16:-16], full[:, 16:-16], rtol=0, atol=2e-5)


def test_spatial_loss_grads_match_reference(run):
    """make_spatial_loss at 2 ranks: the loss, the parameters' gradients
    and lr's (through the halo exchange's backward) equal the reference's
    single-device objective (zero-halo pad, crop), on both ranks; the
    one-rank path computes the same objective."""
    want = run[1]["spatial"]
    for rank in range(WORLD):
        got = _result(run, "spatial_loss", rank)
        _close(got["loss"], want["loss"], rtol=1e-5)
        for k, g in got["grads"].items():
            _close(g, want["grads"][k], rtol=1e-4, atol=1e-6)
        _close(got["lr_grad"], want["lr_grad"], rtol=1e-4, atol=1e-6)
    one = _check_spatial_loss(_jax_models()[2], ONE)
    _close(one["loss"], want["loss"], rtol=1e-5)


def test_pipeline_apply_matches_sequential(run):
    """pipeline_apply over 2 pipe ranks, 3 microbatches: the output and
    the gradients of every stage's tensors and of x equal the sequential
    loop's, on both ranks."""
    stages, x, tgt = _dense_stages()
    sp = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()}
          for s in stages]
    xt = torch.from_numpy(x).requires_grad_()
    outs = []
    for m in range(x.shape[0]):
        u = xt[m]
        for s in sp:
            u = _dense_stage(s, u)
        outs.append(u)
    out = torch.stack(outs)
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    grads = torch.autograd.grad(loss, [t for s in sp for t in s.values()]
                                + [xt])
    for rank in range(WORLD):
        got = _result(run, "pipeline_apply", rank)
        _close(got["out"], out.detach().numpy())
        for a, b in zip(got["grads"], grads):
            _close(a, b.numpy(), rtol=1e-5, atol=1e-6)


def test_trunk_pipeline_matches_reference(run):
    """make_trunk_pipeline: 5 RRDBs over 2 pipe ranks (3 + 2) equals the
    reference's pipelined trunk on a 2-device pipe mesh (a zero-padded
    slot there)."""
    got = _result(run, "trunk_pipeline")
    np.testing.assert_array_equal(got, _result(run, "trunk_pipeline", 1))
    _close(got, run[1]["pipe"]["trunk"], rtol=1e-5, atol=1e-5)


def test_hat_group_pipeline_matches_reference(run):
    """make_hat_group_pipeline: 3 residual groups over 2 pipe ranks (2 +
    1) equals the port's groups run in turn to 1e-6, and the reference's
    sequential group loop to 1e-4 of max |ref| (the bar
    tests/test_torch_hat_lite.py holds the port's HATLite to)."""
    from superresolution_tpu_torch.models.hat_lite import HATLite

    got = _result(run, "hat_group_pipeline")
    m = HATLite(device="cpu", **HAT)
    m.load_state_dict(_t(_jax_models()[2]["hat"]))
    with torch.no_grad():
        seq = []
        for u in torch.from_numpy(_hat_feats()):
            for layer in m.layers:
                u = layer(u)
            seq.append(u)
    _close(got, torch.stack(seq).numpy(), rtol=0, atol=1e-6)
    want = run[1]["pipe"]["hat"]
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4


def test_pipeline_loss_grads_match_reference(run):
    """make_pipeline_loss (n_micro 2, 5 RRDBs over 2 pipe ranks,
    replicated head and tail) equals the reference's plain L1 loss, and
    so does every parameter's gradient, on both ranks; a batch that
    n_micro does not divide raises as there."""
    want = run[1]["pipe"]
    for rank in range(WORLD):
        got = _result(run, "pipeline_loss", rank)
        _close(got["loss"], want["loss"], rtol=1e-5)
        for k, v in got["grads"].items():
            _close(v, want["grads"][k], rtol=1e-4, atol=1e-5)
        assert "not divisible" in got["err"]


def test_cli_mesh_runs(run):
    """The command line's multi-process paths: `train --mesh-data 2`
    prints its result on rank 0 alone, after the steps of a 2-way data
    mesh; `upscale --mesh-data 2` of the committed anchor (the staged
    tiler's tiles over both ranks, f32 trunk and tail as the reference's
    cli/main.py:218-254) saves on rank 0 alone the image the
    single-device staged tiler gives, to 1e-5."""
    import json

    from superresolution_tpu_torch.infer.tiled_device import (
        make_tiled_infer_staged,
    )
    from superresolution_tpu_torch.train.checkpoint import (
        load_params_for_inference,
    )
    from superresolution_tpu_torch.models.factory import build_from_config
    from superresolution_tpu_torch.utils.config import ModelConfig

    got, other = _result(run, "cli"), _result(run, "cli", 1)
    lines = got["printed"].strip().splitlines()
    result = json.loads(lines[0])
    assert result["epochs"] == 1 and result["final_step"] >= 1
    assert "saved to" in lines[-1] and len(lines) == 2
    assert other["printed"] == "" and other["img"] is None
    params, mc = load_params_for_inference(ANCHOR, with_config=True,
                                           device="cpu")
    mc.pop("output_size", None)
    model = build_from_config(ModelConfig(**mc), output_size=None,
                              device="cpu")
    model.load_state_dict(params)
    img = _anchor_img()
    want = make_tiled_infer_staged(model.trunk, model.tail, 4, 8, 4,
                                   tail_batch=4, h=16, w=24, channels=3,
                                   device="cpu")(torch.from_numpy(
                                       np.round(img * 255) / 255))
    assert got["img"].shape == (64, 96, 3)
    _close(got["img"], want.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# in one process: the mesh's rules, split_scan_params, the refusals
# ---------------------------------------------------------------------------

def test_mesh_validation_matches_reference():
    """create_mesh's errors are the reference's, word for word, at a world
    of one process; a mesh that fits takes the reference's axis names."""
    import jax

    from superresolution_tpu.parallel import create_mesh as jax_mesh
    from superresolution_tpu.utils.config import MeshConfig as JCfg
    from superresolution_tpu_torch.utils.config import MeshConfig

    for kw in (dict(data=2), dict(data=1, spatial=2), dict(data=2, pipe=2),
               dict(data=1, pipe=2, spatial=2)):
        with pytest.raises(ValueError) as want:
            jax_mesh(JCfg(**kw), devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            create_mesh(MeshConfig(**kw))
        assert str(got.value) == str(want.value)
    mesh = create_mesh(MeshConfig())
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.groups == {}
    assert create_mesh(MeshConfig(pipe=1, data=1)).coords == {
        "data": 0, "spatial": 0}


def test_shard_batch_takes_this_ranks_rows():
    """shard_batch / batch_sharding: rank d of the data axis holds rows
    [d * b / n, (d + 1) * b / n) of every array (rank 3 of a 2 x 2
    data x pipe mesh: data coordinate 1); replicated_sharding holds them
    all; a batch that does not divide raises."""
    from superresolution_tpu_torch.parallel.mesh import (
        batch_sharding,
        replicated_sharding,
        shard_batch,
    )

    mesh = Mesh(("data", "pipe"), (2, 2), rank=3)
    assert mesh.coords == {"data": 1, "pipe": 1}
    assert mesh.axis_ranks("data") == [1, 3]
    assert mesh.axis_ranks("pipe") == [2, 3]
    batch = {"hr": torch.arange(8.0).reshape(4, 2),
             "lr": torch.arange(4.0)}
    got = shard_batch(mesh, batch)
    assert torch.equal(got["hr"], batch["hr"][2:])
    assert torch.equal(got["lr"], batch["lr"][2:])
    assert torch.equal(batch_sharding(mesh)(batch["lr"]), batch["lr"][2:])
    assert replicated_sharding(mesh)(batch["lr"]) is batch["lr"]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, torch.zeros(3))


def test_split_scan_params_matches_reference():
    """The stage layout: split_scan_params' blocks and valid mask equal
    the reference's, and stage_ranges runs the valid slots."""
    import jax.numpy as jnp

    from superresolution_tpu.parallel.pipeline import (
        split_scan_params as jax_split,
    )
    from superresolution_tpu_torch.parallel.pipeline import (
        split_scan_params,
        stage_ranges,
    )

    for n_items, n_stages in ((5, 4), (23, 2), (23, 4), (3, 3)):
        stacked = np.arange(n_items * 2, dtype=np.float32).reshape(n_items,
                                                                   2)
        blocks, valid = split_scan_params({"k": torch.from_numpy(stacked)},
                                          n_items, n_stages)
        jb, jv = jax_split({"k": jnp.asarray(stacked)}, n_items, n_stages)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(blocks["k"].numpy(),
                                      np.asarray(jb["k"]))
        ranges = stage_ranges(n_items, n_stages)
        for s, r in enumerate(ranges):
            assert list(r) == [int(b) for b, v in zip(
                np.asarray(jb["k"])[s, :, 0] // 2, np.asarray(jv)[s]) if v]
    with pytest.raises(ValueError, match="leading axis"):
        split_scan_params({"k": torch.zeros(4, 1)}, 5, 2)


def test_pipeline_stage_count_mismatch_raises():
    from superresolution_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = Mesh(("data", "pipe"), (1, 4), rank=0)
    stages = [{"w": torch.zeros(8, 8), "b": torch.zeros(8)}] * 3
    with pytest.raises(ValueError, match="3 stages for a 4-device 'pipe'"):
        pipeline_apply(mesh, _dense_stage, stages, torch.zeros(2, 1, 8))


def test_trainer_pipe_refusals(tmp_path):
    """mesh.pipe > 1 refuses GAN training, an arch that is not an RRDBNet
    with scan_blocks, and a per-step batch pipe_microbatches does not
    divide, with the reference's messages (checked before any rank is
    needed)."""
    from superresolution_tpu_torch.train.trainer import Trainer
    from superresolution_tpu_torch.utils.config import MeshConfig

    mesh = Mesh(("data", "pipe"), (1, 2), rank=0)
    base = _trainer_cfg(MeshConfig(data=1, pipe=2), "refuse")
    espcn = base.replace(model=dataclasses.replace(
        base.model, name="espcn", kwargs={"f1": 8, "f2": 8}))
    gan = base.replace(loss=dataclasses.replace(
        base.loss, terms={"l1": 1.0, "gan": 0.005}))
    odd = base.replace(mesh=dataclasses.replace(base.mesh,
                                                pipe_microbatches=3))
    for cfg, msg in ((espcn, "requires an RRDBNet arch with scan_blocks"),
                     (gan, "does not support GAN training"),
                     (odd, "per-step batch 2 not divisible by "
                           "pipe_microbatches 3")):
        with pytest.raises(ValueError, match=msg):
            Trainer(cfg, str(tmp_path), device="cpu", mesh=mesh)
    outside = Mesh(("data", "spatial"), (1, 1), rank=1)
    with pytest.raises(ValueError, match="outside"):
        Trainer(base, str(tmp_path), device="cpu", mesh=outside)
