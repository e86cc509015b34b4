"""The port's GAN training (superresolution_tpu_torch/losses/gan.py,
models/discriminator.py, train/gan.py and the Trainer's GAN branch)
against the JAX package on the CPU, from the same numpy inputs.

- The relativistic losses and their gradients, logits up to +-10: 1e-6.
- VGGStyleDiscriminator at features 16, input 32, 1 and 3 channels, the
  weights bridged (models/convert.discriminator_state_dict_from_jax):
  logits within 1e-5; a wrong-size input raises.
- make_gan_steps on tests/test_train.py's ESPCN (f1 8) with
  gan_start_step 2 and accum_steps 2, three steps on the same batches
  (real LR in the batch, so no degradation draw enters): G's and D's
  params within 1e-5 after each step, the logs within 1e-5, adv_on 0, 0,
  1; D's params, moments and count bit-equal to its init through the
  warm-up and moved after the third step.
- The same step with the fused train apply (the plain B1 / kernel 13
  versions on the CPU, row-packed) against the plain apply at a 2-block
  RRDBNet.
- The Trainer: a GAN fit, and D's resume from checkpoints_disc/.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_tpu.losses.combined import CombinedLoss as JaxLoss
from superresolution_tpu.losses.gan import (
    relativistic_gan_d_loss as jax_d_loss,
    relativistic_gan_g_loss as jax_g_loss,
)
from superresolution_tpu.models import ESPCN as JaxESPCN
from superresolution_tpu.models.discriminator import (
    VGGStyleDiscriminator as JaxDisc,
)
from superresolution_tpu.train.gan import make_gan_steps as jax_make_gan
from superresolution_tpu.train.state import (
    create_train_state as jax_create_state,
    make_optimizer as jax_make_opt,
)
from superresolution_tpu.train.steps import make_device_input as jax_input
from superresolution_tpu.utils import config as jcfg
from superresolution_tpu.utils.precision import get_policy as jax_policy
from superresolution_tpu_torch.losses.combined import CombinedLoss
from superresolution_tpu_torch.losses.gan import (
    relativistic_gan_d_loss,
    relativistic_gan_g_loss,
)
from superresolution_tpu_torch.models import convert
from superresolution_tpu_torch.models.discriminator import (
    VGGStyleDiscriminator,
    same_pad,
)
from superresolution_tpu_torch.models.espcn import ESPCN
from superresolution_tpu_torch.models.rrdbnet import RRDBNet
from superresolution_tpu_torch.train.fused_apply import (
    make_fused_train_apply,
)
from superresolution_tpu_torch.train.gan import make_gan_steps
from superresolution_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from superresolution_tpu_torch.train.steps import make_device_input
from superresolution_tpu_torch.train.trainer import Trainer
from superresolution_tpu_torch.utils import config as tcfg
from superresolution_tpu_torch.utils.precision import get_policy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These CPU tensors are small: intra-op threads gain nothing, and on
    a host loaded by parallel test workers their spin-waits cost several
    times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SRTPU_NO_TB", "1")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---- the relativistic losses ----

@pytest.mark.parametrize("which", ["d", "g"])
@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_gan_losses_and_grads_match_jax(which, scale):
    rng = np.random.default_rng(3)
    real = (rng.standard_normal((6, 1)) * scale).astype(np.float32)
    fake = (rng.standard_normal((6, 1)) * scale).astype(np.float32)
    real[0, 0], fake[1, 0] = 10.0, -10.0  # the saturated ends
    jfn = jax_d_loss if which == "d" else jax_g_loss
    tfn = relativistic_gan_d_loss if which == "d" else relativistic_gan_g_loss
    jv, (jgr, jgf) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(real), jnp.asarray(fake))
    tr = torch.from_numpy(real).requires_grad_()
    tf = torch.from_numpy(fake).requires_grad_()
    tv = tfn(tr, tf)
    tv.backward()
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), atol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), atol=1e-6)


def test_gan_losses_take_bf16_logits_in_f32():
    x = torch.tensor([[0.5], [-1.25]], dtype=torch.bfloat16)
    assert relativistic_gan_d_loss(x, x.flip(0)).dtype == torch.float32


# ---- the discriminator ----

@pytest.mark.parametrize("n,k,s", [(32, 4, 2), (31, 4, 2), (8, 3, 1),
                                   (1, 4, 2), (5, 3, 2)])
def test_same_pad_matches_lax(n, k, s):
    ((lo, hi),) = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert same_pad(n, k, s) == (lo, hi)


def _disc_pair(c, seed=0, features=16, size=32):
    jd = JaxDisc(in_channels=c, features=features, input_size=size)
    jp = jax.jit(jd.init)(jax.random.key(seed), jnp.zeros((1, size, size, c)))
    td = VGGStyleDiscriminator(in_channels=c, features=features,
                               input_size=size, device="cpu")
    td.load_state_dict(convert.to_torch(
        convert.discriminator_state_dict_from_jax(_np(jp))), strict=True)
    return jd, jp, td


@pytest.mark.parametrize("c", [1, 3])
def test_discriminator_matches_jax(c):
    jd, jp, td = _disc_pair(c)
    x = np.random.default_rng(c).random((2, 32, 32, c), dtype=np.float32)
    want = np.asarray(jd.apply(jp, jnp.asarray(x)))
    got = td(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_discriminator_rejects_a_wrong_size():
    td = VGGStyleDiscriminator(1, features=8, input_size=32, device="cpu")
    with pytest.raises(ValueError, match="built for 32"):
        td(torch.zeros(1, 64, 64, 1))


def test_discriminator_init_follows_flax():
    """No bias where a norm follows, GroupNorm at flax's epsilon, the
    Dense head sized to the declared input, zero biases, and the
    parameter shapes of the bridged JAX tree."""
    td = VGGStyleDiscriminator(3, features=16, input_size=32, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    _, jp, _ = _disc_pair(3)
    want = convert.discriminator_state_dict_from_jax(_np(jp))
    got = td.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    assert td.blocks[0].conv.bias is not None
    assert all(b.conv.bias is None and b.norm.eps == 1e-6
               for b in td.blocks[1:])
    assert td.fc1.in_features == 16 * 8 * 1 * 1
    assert float(td.fc1.bias.detach().abs().sum()) == 0.0
    # lecun-normal: std sqrt(1 / fan_in), truncated at 2 std
    w = td.fc1.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / td.fc1.in_features) ** 0.5 \
        / 0.8796 + 1e-6


# ---- the GAN step against the JAX one ----

def _gan_setup():
    jm = JaxESPCN(scale=2, in_channels=1, out_channels=1, f1=8, f2=8)
    jg = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 1)))
    jd, jdp, _ = _disc_pair(1, seed=1)
    tm = ESPCN(scale=2, in_channels=1, out_channels=1, f1=8, f2=8,
               device="cpu")
    tm.load_state_dict(convert.to_torch(
        convert.espcn_state_dict_from_jax(_np(jg))), strict=True)
    td = VGGStyleDiscriminator(1, features=16, input_size=32, device="cpu")
    td.load_state_dict(convert.to_torch(
        convert.discriminator_state_dict_from_jax(_np(jdp))), strict=True)
    return jm, jg, jd, jdp, tm, td


def _batches():
    rng = np.random.default_rng(7)
    return [{"hr": rng.random((4, 32, 32, 1), dtype=np.float32),
             "lr": rng.random((4, 16, 16, 1), dtype=np.float32)}
            for _ in range(3)]


def _jax_params(state, sd_fn):
    return {k: np.asarray(v) for k, v in sd_fn(_np(state.params)).items()}


def _jax_d_grad(jm, jd, g_params, d_params, batch) -> dict:
    """The reference step's D gradient (train/gan.py:64-70 there: D's
    relativistic loss on the HR and on the stop-gradient pred, averaged
    over the 2 micro-batches), in the port's names."""
    def loss(dp, lr, hr):
        pred = jax.lax.stop_gradient(jm.apply(g_params, lr))
        return jax_d_loss(jd.apply(dp, hr), jd.apply(dp, pred))

    lr, hr = jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"])
    g = jax.tree.map(lambda a, b: (a + b) / 2,
                     jax.grad(loss)(d_params, lr[:2], hr[:2]),
                     jax.grad(loss)(d_params, lr[2:], hr[2:]))
    return convert.discriminator_state_dict_from_jax(_np(g))


def _assert_step_close(got, want, grad, msg):
    """Within 1e-5. A first AdamW step moves each param by lr * g / (|g|
    + 1e-8): where the reference's |g| is under 1000 eps = 1e-5 that
    quotient is not +-1 to 1e-3, and f32 noise in g (each framework sums
    in its own order; at max |g| ~ 0.1 it reaches 1e-7) moves it by up to
    2 lr. So, given the step's gradient (which the test holds to the
    reference's within 1e-5 of its max before this), those params are
    held to 2 lr = 2e-3 and the rest to 1e-5."""
    tight = np.ones(want.shape, bool) if grad is None else (
        np.abs(grad) > 1e-5)
    np.testing.assert_allclose(got[tight], want[tight], atol=1e-5,
                               err_msg=msg)
    np.testing.assert_allclose(got, want, atol=2e-3, err_msg=msg)


def test_gan_steps_match_jax():
    jm, jg, jd, jdp, tm, td = _gan_setup()
    tc = dict(lr=1e-3, precision="fp32")
    dc = dict(degradation="bicubic", augment=False)
    jtx, _ = jax_make_opt(jcfg.TrainConfig(**tc), 100)
    jdtx, _ = jax_make_opt(jcfg.TrainConfig(**tc), 100)
    jstep = jax.jit(jax_make_gan(
        jm, jd, JaxLoss(jcfg.LossConfig(terms={"l1": 1.0})), jtx, jdtx,
        jax_policy("fp32"), jax_input(jcfg.DataConfig(**dc), scale=2),
        gan_weight=0.01, gan_start_step=2, accum_steps=2))
    jgs = jax_create_state(jg, jtx)
    jds = jax_create_state(jdp, jdtx)

    ttx, _ = make_optimizer(tcfg.TrainConfig(**tc), 100)
    tdtx, _ = make_optimizer(tcfg.TrainConfig(**tc), 100)
    tstep = make_gan_steps(
        tm, td, CombinedLoss(tcfg.LossConfig(terms={"l1": 1.0})), ttx, tdtx,
        get_policy("fp32"), make_device_input(tcfg.DataConfig(**dc), 2),
        gan_weight=0.01, gan_start_step=2, accum_steps=2)
    tgs = create_train_state({k: p.detach().clone()
                              for k, p in tm.named_parameters()}, ttx)
    tds = create_train_state({k: p.detach().clone()
                              for k, p in td.named_parameters()}, tdtx)
    d_applied = []  # the gradients the port's step hands D's optimizer
    d_update = tdtx.update_

    def spy(grads, opt_state, params):
        d_applied.append({k: g.detach().clone() for k, g in grads.items()})
        return d_update(grads, opt_state, params)

    tdtx.update_ = spy
    d0 = {k: v.clone() for k, v in tds.params.items()}
    mu0 = {k: v.clone() for k, v in tds.opt_state["mu"].items()}
    nu0 = {k: v.clone() for k, v in tds.opt_state["nu"].items()}

    for i, batch in enumerate(_batches()):
        jg_before, jds_before = jgs.params, jds.params
        jgs, jds, jlogs = jstep(jgs, jds, jax.tree.map(jnp.asarray, batch),
                                jax.random.key(i))
        tgs, tds, tlogs = tstep(tgs, tds, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, None)
        assert sorted(tlogs) == sorted(jlogs)
        for k in jlogs:
            np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} log {k}")
        assert float(tlogs["adv_on"]) == (0.0, 0.0, 1.0)[i]
        assert len(d_applied) == (0, 0, 1)[i]
        if i == 2:  # D's first update: its gradient, as the JAX step's
            d_grad = _jax_d_grad(jm, jd, jg_before, jds_before, batch)
            # within 1e-5 of the whole gradient's max (fc2.bias's own
            # gradient is ~3e-8: the relativistic loss cancels it)
            assert sorted(d_applied[0]) == sorted(d_grad)
            g_max = max(float(np.abs(w).max()) for w in d_grad.values())
            for k, want in d_grad.items():
                np.testing.assert_allclose(
                    d_applied[0][k].numpy(), want, atol=1e-5 * g_max,
                    err_msg=f"step {i} D gradient {k}")
        for want, got, grad in (
                (_jax_params(jgs, convert.espcn_state_dict_from_jax),
                 tgs.params, None),
                (_jax_params(jds,
                             convert.discriminator_state_dict_from_jax),
                 tds.params, d_grad if i == 2 else None)):
            for k in want:
                _assert_step_close(got[k].numpy(), want[k],
                                   None if grad is None else grad[k],
                                   f"step {i} param {k}")
        held = (tds.opt_state["count"] == 0 and tds.step == 0
                and all(torch.equal(tds.params[k], d0[k]) for k in d0)
                and all(torch.equal(tds.opt_state["mu"][k], mu0[k])
                        and torch.equal(tds.opt_state["nu"][k], nu0[k])
                        for k in d0))
        assert held == (i < 2), f"step {i}: D held {held}"
        assert int(jds.step) == (0, 0, 1)[i] == tds.step
    assert tgs.step == 3


def test_gan_step_rejects_an_indivisible_batch():
    _, _, _, _, tm, td = _gan_setup()
    tc = tcfg.TrainConfig(lr=1e-3, precision="fp32")
    tx, _ = make_optimizer(tc, 10)
    step = make_gan_steps(
        tm, td, CombinedLoss(tcfg.LossConfig(terms={"l1": 1.0})), tx, tx,
        get_policy("fp32"),
        make_device_input(tcfg.DataConfig(augment=False), 2),
        gan_weight=0.01, accum_steps=3)
    gs = create_train_state({k: p.detach().clone()
                             for k, p in tm.named_parameters()}, tx)
    ds = create_train_state({k: p.detach().clone()
                             for k, p in td.named_parameters()}, tx)
    batch = {k: torch.from_numpy(v[:4]) for k, v in _batches()[0].items()}
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(gs, ds, batch, None)


# ---- the fused apply under the GAN step ----

def test_fused_gan_step_matches_the_plain_step():
    """The GAN step with the row-packed fused train apply (B1 forward,
    kernel 13 backward: their plain versions on the CPU) against the same
    step through the plain model, from the same state and batch, in the
    adversarial phase: G's and D's params and every log within 1e-5."""
    gen = torch.Generator().manual_seed(5)
    model = RRDBNet(scale=2, in_channels=1, out_channels=1, features=8,
                    num_blocks=2, growth=4, device="cpu", generator=gen)
    disc = VGGStyleDiscriminator(1, features=8, input_size=16, device="cpu",
                                 generator=gen)
    tc = tcfg.TrainConfig(lr=1e-3, precision="fp32")
    lc = tcfg.LossConfig(terms={"l1": 1.0, "gan": 0.01})
    rng = np.random.default_rng(11)
    batch = {"hr": torch.from_numpy(rng.random((4, 16, 16, 1),
                                               dtype=np.float32)),
             "lr": torch.from_numpy(rng.random((4, 8, 8, 1),
                                               dtype=np.float32))}
    runs = []
    for apply in (None, make_fused_train_apply(model, row_pack=True)):
        tx, _ = make_optimizer(tc, 10)
        dtx, _ = make_optimizer(tc, 10)
        step = make_gan_steps(
            model, disc, CombinedLoss(lc), tx, dtx, get_policy("fp32"),
            make_device_input(tcfg.DataConfig(augment=False), 2),
            gan_weight=0.01, accum_steps=2, gen_apply_fn=apply)
        gs = create_train_state({k: p.detach().clone()
                                 for k, p in model.named_parameters()}, tx)
        ds = create_train_state({k: p.detach().clone()
                                 for k, p in disc.named_parameters()}, dtx)
        gs, ds, logs = step(gs, ds, batch, None)
        runs.append((gs.params, ds.params, logs))
    (g0, d0, l0), (g1, d1, l1) = runs
    assert float(l1["adv_on"]) == 1.0
    for k in l0:
        np.testing.assert_allclose(float(l1[k]), float(l0[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for a, b in ((g0, g1), (d0, d1)):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-5,
                                       err_msg=k)


# ---- the Trainer ----

def _gan_config(resume: bool, epochs: int = 1):
    return tcfg.Config(
        name="gan_test",
        model=tcfg.ModelConfig(name="espcn", scale=2, in_channels=1,
                               out_channels=1, kwargs={"f1": 8, "f2": 8}),
        data=tcfg.DataConfig(hr_patch=32, batch_size=2, synthetic_len=2,
                             degradation="bicubic", augment=False,
                             num_workers=1),
        loss=tcfg.LossConfig(terms={"l1": 1.0, "gan": 0.01}),
        train=tcfg.TrainConfig(epochs=epochs, lr=1e-3, eval_every=1,
                               preview_every=1000, precision="fp32",
                               resume=resume),
    )


def test_trainer_gan_fits_and_resumes_the_discriminator(tmp_path, caplog):
    wd = str(tmp_path)
    with Trainer(_gan_config(False, epochs=2), wd, device="cpu") as tr:
        assert tr.is_gan and tr.disc.input_size == 32
        assert not hasattr(tr, "_train_step")
        d_init = {k: v.clone() for k, v in tr.d_state.params.items()}
        out = tr.fit()
        assert out["final_step"] == 2 and np.isfinite(out["best"]["psnr"])
        assert tr.d_state.step == 2  # gan_start_step 0: D trains each step
        # the module's parameters are D's masters
        for k, p in tr.disc.named_parameters():
            assert p.data_ptr() == tr.d_state.params[k].data_ptr()
        assert any(not torch.equal(d_init[k], v)
                   for k, v in tr.d_state.params.items())
        trained = {k: v.clone() for k, v in tr.d_state.params.items()}
        trained_mu = {k: v.clone()
                      for k, v in tr.d_state.opt_state["mu"].items()}
    with Trainer(_gan_config(True, epochs=2), wd, device="cpu") as tr2:
        assert tr2.state.step == 2 and tr2.d_state.step == 2
        for k, v in trained.items():
            assert torch.equal(tr2.d_state.params[k], v), k
            assert torch.equal(tr2.d_state.opt_state["mu"][k],
                               trained_mu[k]), k
            assert torch.equal(dict(tr2.disc.named_parameters())[k].data, v)
    # a G checkpoint without D's: the reference's warning, a fresh D
    import shutil

    shutil.rmtree(tmp_path / "checkpoints_disc")
    with caplog.at_level("WARNING"):
        with Trainer(_gan_config(True, epochs=2), wd, device="cpu") as tr3:
            assert tr3.d_state.step == 0
    assert "without a saved discriminator state" in caplog.text


def test_trainer_gan_discriminator_from_seed_plus_one(tmp_path):
    cfg = _gan_config(False)
    with Trainer(cfg, str(tmp_path), device="cpu") as tr:
        want = VGGStyleDiscriminator(
            1, input_size=32, device="cpu",
            generator=torch.Generator().manual_seed(cfg.train.seed + 1))
        for k, v in want.state_dict().items():
            assert torch.equal(tr.disc.state_dict()[k], v), k


def test_esrgan_gan_preset_builds_its_gan_step(tmp_path):
    cfg = tcfg.get_preset("esrgan_gan")
    mc = dataclasses.replace(cfg.model, kwargs={"features": 8,
                                                "num_blocks": 1,
                                                "growth": 4})
    data = dataclasses.replace(cfg.data, hr_patch=32, batch_size=2,
                               synthetic_len=2, num_workers=1)
    cfg = cfg.replace(model=mc, data=data)
    with Trainer(cfg, str(tmp_path), device="cpu") as tr:
        assert tr.is_gan and tr.disc.input_size == 32
        assert tr.d_tx.schedule(0) == pytest.approx(cfg.train.disc_lr)
        assert tr.disc.blocks[0].conv.in_channels == 3
